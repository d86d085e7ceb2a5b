"""The port's fleet controller (``repro_torch.tuna.controller``) and the
CLI's ``controller`` command, held against the reference's.

The port's copies of ``tests/test_controller.py``'s cells (lease-tracked
dispatch, crash healing, resume, the HTTP schedule/health/metrics API,
``query --json`` and the freshness stamps), then the cross-package checks:
the port's and the reference's controllers, each healing the same injected
crash over the same job matrix, converge to the same store record for
record (bookkeeping meta aside), their ``/schedule`` answers are equal,
and the CLI's ``controller`` command runs with process workers to
convergence. Then each example's ``main`` on the CPU at its own size.
Everything is static and in-process except that command.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from repro.tuna import controller as jcontroller
from repro.tuna.transport import MemoryTransport as JMemoryTransport
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.tuna import cli, fleet, orchestrator
from repro_torch.tuna.cache import ScheduleCache, SnapshotManager, read_snapshot_header
from repro_torch.tuna.controller import (
    ControllerConfig,
    ControllerMetrics,
    FleetController,
    ThreadWorker,
    start_http,
)
from repro_torch.tuna.db import (
    ScheduleDatabase,
    ScheduleRecord,
    record_to_dict,
    strip_bookkeeping,
)
from repro_torch.tuna.fleet import ShardLease
from repro_torch.tuna.transport import MemoryTransport

JOB_OPS = ["dense_256", "batch_matmul"]
JOB_TARGETS = ["gpu_h100"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _port_store_off(monkeypatch):
    """No process default store or snapshot leaks into (or out of) a test."""
    for var in ("REPRO_TUNA_DB", "REPRO_TUNA_CACHE", "REPRO_TUNA_BUNDLE"):
        monkeypatch.delenv(var, raising=False)


def _matrix(targets=JOB_TARGETS):
    return orchestrator.jobs_for(JOB_OPS, targets, limit=64)


def _mem(tmp_path, cls=MemoryTransport, tag="ctl"):
    bucket = f"{tag}-{os.path.basename(tmp_path)}"
    cls.wipe(bucket)
    return cls(bucket)


def _cfg(tmp_path, config=ControllerConfig, **kw):
    kw.setdefault("db", str(tmp_path / "ctl" / "fleet.jsonl"))
    kw.setdefault("ops", JOB_OPS)
    kw.setdefault("targets", JOB_TARGETS)
    kw.setdefault("limit", 64)
    kw.setdefault("num_shards", 2)
    kw.setdefault("poll_s", 0.01)
    kw.setdefault("worker_procs", 1)
    kw.setdefault("quiet", True)
    return config(**kw)


def _strip(db):
    """Comparable record tuples with bookkeeping meta (provenance,
    tuned_at) removed — the single-vs-fleet parity form."""
    return [
        (r.op, r.target, r.version, json.dumps(r.config, sort_keys=True),
         r.score, r.evaluations, strip_bookkeeping(r.meta))
        for r in db.records()
    ]


def _rec(op="matmul[x]", score=1.0, meta=None) -> ScheduleRecord:
    return ScheduleRecord(
        op=op, target="gpu_h100", version=COST_MODEL_VERSION,
        config={"tile": 8}, score=score, evaluations=1,
        meta=dict(meta or {}))


# -- crash-skip probe + lease primitives -----------------------------------

class TestShardPresence:
    def test_shared_fs(self, tmp_path):
        base = str(tmp_path / "f.jsonl")
        assert not fleet.shard_present(base, 0)
        assert fleet.missing_shards(base, 2) == [0, 1]
        fleet.touch_store(fleet.shard_store_path(base, 1))
        assert fleet.shard_present(base, 1)
        assert fleet.missing_shards(base, 2) == [0]

    def test_transport_manifest_is_the_marker(self, tmp_path):
        t = _mem(tmp_path)
        base = str(tmp_path / "f.jsonl")
        assert fleet.missing_shards(base, 2, transport=t) == [0, 1]
        run = fleet.run_shard(_matrix(), 2, 0, base, transport=t, workers=1)
        assert run.ok and run.pushed is not None
        assert fleet.shard_present(base, 0, transport=t)
        # the channel is authoritative: shard 1 never pushed
        assert not fleet.shard_present(base, 1, transport=t)


class TestShardLease:
    def test_deadline_and_expiry(self):
        lease = ShardLease(shard_id=0, jobs=3, granted_at=100.0, lease_s=5.0)
        assert lease.deadline == 105.0
        assert lease.last_heartbeat == 100.0
        assert not lease.expired(now=104.9)
        assert lease.expired(now=105.1)
        lease.heartbeat(now=103.0)
        assert lease.last_heartbeat == 103.0
        # heartbeats renew liveness, never the deadline
        assert lease.expired(now=105.1)


class TestThreadWorker:
    def test_exit_codes(self):
        ok = ThreadWorker(lambda cancelled: True)
        bad = ThreadWorker(lambda cancelled: False)

        def _boom(cancelled):
            raise RuntimeError("x")

        crash = ThreadWorker(_boom)
        deadline = time.monotonic() + 10
        while any(w.poll() is None for w in (ok, bad, crash)):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert (ok.poll(), bad.poll(), crash.poll()) == (0, 2, 1)

    def test_kill_reports_minus_9_and_cancels(self):
        started = threading.Event()

        def _hang(cancelled):
            started.set()
            cancelled.wait(30)

        w = ThreadWorker(_hang)
        assert started.wait(10)
        assert w.poll() is None
        w.kill()
        assert w.poll() == -9
        assert w.cancelled.is_set()


# -- heal a killed worker, converge, match a single run ---------------------

class TestControllerHealing:
    def test_injected_crash_heals_and_matches_single_run(self, tmp_path):
        """On mem://, one worker dies mid-shard, the shard is re-dispatched,
        and the final store is record-for-record identical to a clean
        single-process ``run_fleet``."""
        t = _mem(tmp_path)
        cfg = _cfg(tmp_path, transport=t, inject_crash_shard=0)
        ctl = FleetController(cfg)
        shard0_jobs = ctl._shard_jobs[0]
        rc = ctl.run(exit_when_converged=True)
        assert rc == 0 and ctl.converged and not ctl.wedged
        assert ctl.metrics.get("shards_healed_total") == 1
        assert ctl.metrics.get("jobs_healed_total") == shard0_jobs
        assert ctl.metrics.get("jobs_failed_total") == shard0_jobs
        assert ctl.attempts[0] == 2 and ctl.attempts[1] == 1
        kinds = [e["event"] for e in ctl.events if e["shard"] == 0]
        assert kinds == ["dispatched", "failed", "healed", "dispatched", "done"]
        total = len(ctl.jobs)
        assert ctl.metrics.get("jobs_done_total") == total
        assert ctl.metrics.get("jobs_dispatched_total") == total + shard0_jobs
        assert ctl.metrics.get("sync_divergence") == 0
        clean_base = str(tmp_path / "clean" / "fleet.jsonl")
        assert fleet.run_fleet(ctl.jobs, cfg.num_shards, clean_base, workers=1).ok
        clean = fleet.sync(clean_base, cfg.num_shards)
        merged = ScheduleDatabase(cfg.db)
        assert len(merged) == len(ctl.jobs)
        assert _strip(merged) == _strip(clean.db)
        cache = ScheduleCache.load(ctl.manager.latest_path)
        assert cache.records() == merged.records()

    def test_expired_lease_kills_and_heals(self, tmp_path):
        """A wedged worker (no exit, no store) loses its lease: the
        controller kills it, re-dispatches, and still converges. The lease
        is 3 s (the reference's cell: 0.3 s), long enough for a healthy
        shard on a loaded host and short beside the wedged worker's 30 s."""
        t = _mem(tmp_path)
        cfg = _cfg(tmp_path, transport=t, lease_s=3.0)
        probe = {}

        def factory(shard_id, attempt):
            if shard_id == 0 and attempt == 1:
                def _hang(cancelled):
                    cancelled.wait(30)
                probe["worker"] = ThreadWorker(_hang)
                return probe["worker"]
            return FleetController._default_worker(ctl, shard_id, attempt)

        ctl = FleetController(cfg, worker_factory=factory)
        rc = ctl.run(exit_when_converged=True)
        assert rc == 0 and ctl.converged
        assert ctl.metrics.get("lease_expiries_total") == 1
        assert ctl.metrics.get("shards_healed_total") == 1
        assert probe["worker"].poll() == -9
        assert probe["worker"].cancelled.is_set()
        assert len(ScheduleDatabase(cfg.db)) == len(ctl.jobs)

    def test_gives_up_after_max_attempts(self, tmp_path):
        """A shard that crashes on every dispatch is abandoned: the
        controller reports wedged/degraded instead of spinning."""
        t = _mem(tmp_path)
        cfg = _cfg(tmp_path, transport=t, max_attempts=2)

        def factory(shard_id, attempt):
            if shard_id == 0:
                def _boom(cancelled):
                    raise RuntimeError("always crashes")
                return ThreadWorker(_boom)
            return FleetController._default_worker(ctl, shard_id, attempt)

        ctl = FleetController(cfg, worker_factory=factory)
        rc = ctl.run(exit_when_converged=True)
        assert rc == 1 and ctl.wedged and not ctl.converged
        assert ctl.given_up == {0}
        assert ctl.attempts[0] == 2
        assert ctl.health()["status"] == "degraded"
        assert len(ScheduleDatabase(cfg.db)) == ctl._shard_jobs[1]

    def test_resume_skips_published_shards(self, tmp_path):
        """A restarted controller treats published shard stores as done and
        reconverges without re-tuning anything."""
        t = _mem(tmp_path)
        first = FleetController(_cfg(tmp_path, transport=t))
        assert first.run(exit_when_converged=True) == 0
        second = FleetController(_cfg(tmp_path, transport=t))
        assert second.done == {0, 1}
        assert second.run(exit_when_converged=True) == 0
        assert second.converged
        assert second.metrics.get("jobs_dispatched_total") == 0
        assert len([e for e in second.events if e["event"] == "resumed"]) == 2


# -- HTTP API ----------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.read().decode("utf-8")


def _get_err(port, path):
    try:
        return _get(port, path)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


@pytest.fixture()
def served(tmp_path):
    """A converged controller with its HTTP API bound to an OS-chosen
    port."""
    ctl = FleetController(_cfg(tmp_path, transport=_mem(tmp_path)))
    assert ctl.run(exit_when_converged=True) == 0
    server = start_http(ctl)
    try:
        yield ctl, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


class TestHttpApi:
    def test_healthz(self, served):
        ctl, port = served
        status, body = _get(port, "/healthz")
        assert status == 200
        health = json.loads(body)
        assert health["status"] == "ok" and health["converged"] is True
        assert health["shards"]["done"] == 2
        assert health["snapshot"]["sha1"] == ctl._snapshot_info.sha1
        assert health["snapshot"]["built_at"] is not None

    def test_metrics_exposes_acceptance_series(self, served):
        ctl, port = served
        status, body = _get(port, "/metrics")
        assert status == 200
        assert f"tuna_jobs_done_total {len(ctl.jobs)}" in body
        assert "tuna_jobs_healed_total 0" in body
        assert "tuna_store_lag_seconds " in body
        assert "tuna_snapshot_age_seconds " in body
        assert "tuna_sync_divergence 0" in body
        assert f"tuna_store_records {len(ctl.jobs)}" in body
        assert f'sha1="{ctl._snapshot_info.sha1}"' in body
        for line in body.splitlines():
            if line.startswith(("tuna_store_lag_seconds ", "tuna_snapshot_age_seconds ")):
                assert float(line.split()[-1]) >= 0
        for name, kind, _ in ControllerMetrics.SPEC:
            assert f"# TYPE tuna_{name} {kind}" in body

    def test_schedule_matches_query_json(self, served, capsys):
        """``/schedule`` and ``query --json`` share one serializer."""
        ctl, port = served
        status, body = _get(port, "/schedule?op=matmul&target=gpu_h100")
        assert status == 200
        obj = json.loads(body)
        assert obj["count"] == len(obj["records"]) > 0
        assert obj["snapshot_sha1"] == ctl._snapshot_info.sha1
        assert obj["cost_model_version"] == COST_MODEL_VERSION
        rc = cli.main(["query", "--db", ctl.cfg.db, "--op", "matmul",
                       "--target", "gpu_h100", "--json"])
        assert rc == 0
        assert json.loads(capsys.readouterr().out) == obj["records"]

    def test_schedule_no_match_is_404(self, served):
        _, port = served
        status, body = _get_err(port, "/schedule?op=nope%5B")
        assert status == 404 and "no matching" in body

    def test_unknown_route_is_404(self, served):
        _, port = served
        status, body = _get_err(port, "/nope")
        assert status == 404 and "/schedule" in body

    def test_schedule_before_first_snapshot_is_503(self, tmp_path):
        ctl = FleetController(_cfg(tmp_path))
        server = start_http(ctl)
        try:
            status, body = _get_err(server.server_address[1], "/schedule?op=matmul")
            assert status == 503 and "no snapshot" in body
        finally:
            server.shutdown()
            server.server_close()


# -- query --json --------------------------------------------------------------

class TestQueryJson:
    def test_json_flag_emits_record_to_dict(self, tmp_path, capsys):
        db_path = str(tmp_path / "db.jsonl")
        db = ScheduleDatabase(db_path)
        db.add(_rec(op="matmul[a]", score=2.0, meta={"strategy": "x"}))
        db.add(_rec(op="matmul[b]", score=1.0))
        assert cli.main(["query", "--db", db_path, "--json"]) == 0
        assert json.loads(capsys.readouterr().out) == [record_to_dict(r) for r in db.query()]

    def test_json_flag_empty_is_rc1_with_empty_array(self, tmp_path, capsys):
        db_path = str(tmp_path / "db.jsonl")
        ScheduleDatabase(db_path)
        assert cli.main(["query", "--db", db_path, "--json"]) == 1
        assert json.loads(capsys.readouterr().out) == []


# -- freshness stamps (tuned_at / built_at) -------------------------------------

class TestFreshnessStamps:
    def test_new_records_carry_tuned_at(self, tmp_path):
        db = ScheduleDatabase(str(tmp_path / "db.jsonl"))
        job = orchestrator.jobs_for(["dense_256"], ["gpu_h100"], limit=16)[0]
        before = time.time()
        rec = orchestrator.run_job(job)
        assert before - 1 <= rec.meta["tuned_at"] <= time.time() + 1
        db.add(rec)
        assert db.last_tuned_at() == rec.meta["tuned_at"]

    def test_old_records_without_stamp_still_load_and_merge(self, tmp_path):
        a = str(tmp_path / "a.jsonl")
        ScheduleDatabase(a).add(_rec(op="matmul[old]", meta={"strategy": "x"}))
        db = ScheduleDatabase(str(tmp_path / "b.jsonl"))
        db.merge(a)
        assert db.last_tuned_at() is None
        assert db.best("matmul[old]", "gpu_h100").meta["strategy"] == "x"

    def test_tuned_at_never_decides_a_merge(self, tmp_path):
        a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
        ScheduleDatabase(a).add(_rec(meta={"tuned_at": 1000.0}))
        ScheduleDatabase(b).add(_rec(meta={"tuned_at": 2000.0}))
        db = ScheduleDatabase(str(tmp_path / "m.jsonl"))
        db.merge(a, provenance=False)
        assert db.merge(b, provenance=False) == 0
        assert db.best("matmul[x]", "gpu_h100").meta["tuned_at"] == 1000.0

    def test_snapshot_built_at_roundtrip(self, tmp_path):
        db = ScheduleDatabase(str(tmp_path / "db.jsonl"))
        db.add(_rec())
        path = str(tmp_path / "snap.json")
        cache = ScheduleCache.from_db(db)
        cache.save(path)
        assert cache.built_at is not None
        assert read_snapshot_header(path)["built_at"] == cache.built_at
        assert ScheduleCache.load(path).built_at == cache.built_at

    def test_built_at_outside_the_content_address(self, tmp_path):
        db = ScheduleDatabase(str(tmp_path / "db.jsonl"))
        db.add(_rec())
        a = ScheduleCache.from_db(db)
        a.save(str(tmp_path / "a.json"))
        time.sleep(0.01)
        b = ScheduleCache.from_db(db)
        b.save(str(tmp_path / "b.json"))
        assert a.sha1 == b.sha1

    def test_old_snapshot_without_built_at_still_loads(self, tmp_path):
        db = ScheduleDatabase(str(tmp_path / "db.jsonl"))
        db.add(_rec())
        path = str(tmp_path / "snap.json")
        ScheduleCache.build(db, path)
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        del obj["built_at"]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f, default=float)
        cache = ScheduleCache.load(path)
        assert cache.built_at is None and len(cache) == 1

    def test_noop_ensure_preserves_original_build_stamp(self, tmp_path):
        db_path = str(tmp_path / "db.jsonl")
        ScheduleDatabase(db_path).add(_rec())
        mgr = SnapshotManager(db_path, str(tmp_path / "snaps"))
        first = mgr.ensure()
        assert first.rebuilt and first.built_at is not None
        time.sleep(0.02)
        again = mgr.ensure()
        assert not again.rebuilt
        assert again.sha1 == first.sha1 and again.built_at == first.built_at


# -- against the reference's controller -----------------------------------------

def test_healed_store_and_schedule_equal_the_reference_s(tmp_path):
    """Both controllers, thread workers on their own mem:// channels, tune
    the same matrix on ``tpu_v5e`` (a target both packages have) with shard
    0's first worker crashed: both heal it once and converge, the merged
    stores are equal record for record (bookkeeping meta aside), and the
    two ``/schedule`` answers for the same filter carry the same records."""
    port_ctl = FleetController(_cfg(tmp_path / "port", transport=_mem(tmp_path),
                                    targets=["tpu_v5e"], inject_crash_shard=0))
    ref_ctl = jcontroller.FleetController(_cfg(
        tmp_path / "ref", config=jcontroller.ControllerConfig,
        transport=_mem(tmp_path, JMemoryTransport, "jctl"), targets=["tpu_v5e"],
        inject_crash_shard=0))
    for ctl in (port_ctl, ref_ctl):
        assert ctl.run(exit_when_converged=True) == 0 and ctl.converged
        assert ctl.metrics.get("shards_healed_total") == 1
    assert [(j.op, j.target) for j in port_ctl.jobs] == [(j.op, j.target) for j in ref_ctl.jobs]
    assert port_ctl._shard_jobs == ref_ctl._shard_jobs
    assert _strip(ScheduleDatabase(port_ctl.cfg.db)) == _strip(ScheduleDatabase(ref_ctl.cfg.db))
    servers = [start_http(port_ctl), jcontroller.start_http(ref_ctl)]
    try:
        got = [json.loads(_get(s.server_address[1], "/schedule?op=matmul&target=tpu_v5e")[1])
               for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
    strip = lambda recs: [dict(r, meta=strip_bookkeeping(r["meta"])) for r in recs]
    assert got[0]["count"] == got[1]["count"] > 0
    assert strip(got[0]["records"]) == strip(got[1]["records"])
    assert got[0]["cost_model_version"] == got[1]["cost_model_version"]


def test_cli_controller_flags_and_defaults_match_the_reference_s():
    """Every flag of the reference's ``controller`` subcommand, with its
    default, save ``--db`` (the port's store is given or taken from
    ``$REPRO_TUNA_DB``; the reference defaults to its tracked
    ``experiments/`` store) and ``--targets`` (the port's four targets,
    ``gpu_h100`` first, where the reference lists its three)."""
    from repro.tuna import cli as jcli

    def actions(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in sub.choices["controller"]._actions if a.dest != "help"}

    mine = actions(cli.build_parser())
    ref = actions(jcli.build_parser())
    assert set(mine) == set(ref)
    differ = {k for k in ref if mine[k] != ref[k]}
    assert differ == {"db", "targets"}
    assert mine["targets"][1].split(",")[0] == "gpu_h100"


def test_cli_controller_heals_a_crashed_process_worker(tmp_path):
    """``python -m repro_torch.tuna controller --smoke`` with process
    workers over a dir:// channel, shard 0's first worker crashed: exit 0,
    converged, one shard healed, and the served store queries like the
    CLI's. Unknown targets are exit 2."""
    db = str(tmp_path / "fleet.jsonl")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_TUNA_DB", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuna", "controller", "--db", db, "--smoke",
         "--num-shards", "2", "--transport", f"dir://{tmp_path / 'bucket'}",
         "--worker-mode", "process", "--workers", "1", "--poll-s", "0.05",
         "--inject-crash-shard", "0", "--exit-when-converged", "--port", "0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "exit: converged" in proc.stdout and "1 shards healed" in proc.stdout
    assert "serving http://127.0.0.1:" in proc.stdout
    assert len(ScheduleDatabase(db)) > 0
    bad = subprocess.run([sys.executable, "-m", "repro_torch.tuna", "controller", "--db", db,
                          "--targets", "tpu_v9", "--exit-when-converged"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 2 and "unknown target" in bad.stderr


# -- the examples ------------------------------------------------------------

def test_example_quickstart_picks_the_exhaustive_best_and_runs_it():
    """At 2048^3 in f32 the ES pick scores as the exhaustive best (the space
    has 24 points), and the plain version at the pick's blocks runs it on
    f32 inputs (256^3) within the reference's f32 matmul tolerance (atol
    2e-4 sqrt(K), rtol 2e-4) of the reference's oracle on the same numpy
    inputs, as the reference's quickstart runs its pick."""
    import numpy as np
    from repro.kernels import ref as jref
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert out["device"] == "cpu"
    assert out["config"] == out["exhaustive_best"]
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((256, 256)).astype(np.float32) for _ in range(2))
    assert out["out"].dtype == np.float32 and out["out"].shape == (256, 256)
    np.testing.assert_allclose(out["out"], np.asarray(jref.matmul(x, y)),
                               atol=2e-4 * np.sqrt(256), rtol=2e-4)
    assert out["max_abs_err"] <= 2e-4 * np.sqrt(256)


def test_example_serve_batched_serves_every_request():
    from repro_torch.examples import serve_batched

    out = serve_batched.main(["--device", "cpu", "--requests", "4", "--max-new", "6"])
    assert [len(o) for o in out["outputs"]] == [6] * 4
    assert out["stats"]["tokens"] == 24


def test_example_train_tiny_collapses_the_loss():
    """40 steps on periodic data take the cross-entropy far below the
    uniform floor log(vocab)."""
    from repro_torch.examples import train_tiny

    out = train_tiny.main(["--device", "cpu", "--steps", "40"])
    assert out["ce"][-1] < 0.5 * out["floor"] and out["ce"][-1] < out["ce"][0]


def test_example_train_tiny_full_loop(tmp_path):
    from repro_torch.examples import train_tiny

    out = train_tiny.main(["--device", "cpu", "--steps", "4", "--full-loop",
                           "--ckpt-dir", str(tmp_path / "ck")])
    assert out["final_step"] == 4 and len(out["losses"]) >= 1


def test_example_tune_operator_ranks_and_measures():
    from repro_torch.examples import tune_operator

    out = tune_operator.main(["--device", "cpu", "--size", "128", "--configs", "4",
                              "--iters", "1"])
    assert out["n_configs"] == 4 and 0 < out["top1_ratio"] <= 1


def test_examples_refuse_the_card_when_there_is_none(monkeypatch):
    """Their default device is the card: without one they raise, never run
    on the CPU instead."""
    from repro_torch.examples import quickstart, serve_batched

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, serve_batched):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])

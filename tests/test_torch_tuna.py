"""The port's schedule store (``repro_torch.tuna``, the store tiers of
``repro_torch.core.tuner`` and the flash picker of ``kernels/ops``) held to
the reference's contract, case for case at small sizes: the cases of
``tests/test_tuna.py``, ``tests/test_fleet.py``,
``tests/test_merge_properties.py`` and ``tests/test_transport.py`` on the
port's target ``gpu_h100``. Then the two packages against each other:
stores and snapshots written by either load in the other with the same
best records and the same payload digest, and the flash signatures agree.

Spawned worker processes import this module (the stress, retry and
locked-writer cases), so it imports neither jax nor the reference's jax
modules: ``repro.tuna`` and ``repro.core.op_registry`` are numpy-only.
"""
import dataclasses
import json
import multiprocessing
import os
import time

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import cost_model, op_registry, tuner
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.core.spaces import BatchMatmulSpace, MatmulSpace
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import ops
from repro_torch.tuna import cache as cache_mod
from repro_torch.tuna import cli, fleet, orchestrator
from repro_torch.tuna import db as db_mod
from repro_torch.tuna.cache import (
    POINTER_SCHEMA,
    ScheduleCache,
    SnapshotManager,
    StaleSnapshotError,
    StaleSnapshotWarning,
    read_snapshot_header,
)
from repro_torch.tuna.db import (ScheduleDatabase, ScheduleRecord, record_beats,
                                 strip_bookkeeping)
from repro_torch.tuna.orchestrator import TuneJob
from repro_torch.tuna.transport import (
    IntegrityError,
    LocalDirTransport,
    MemoryTransport,
    TransportError,
    resolve_transport,
)

H100 = "gpu_h100"
MM = "matmul[K=256,M=256,N=256,dtype_bytes=2]"


@pytest.fixture(autouse=True)
def _port_store_off(monkeypatch):
    """The port's process defaults (DB and snapshot) off around every test,
    whatever ``$REPRO_TUNA_DB``/``$REPRO_TUNA_CACHE`` say, and the memos
    cleared, so no test warm-hits another's store."""
    monkeypatch.delenv("REPRO_TUNA_DB", raising=False)
    monkeypatch.delenv("REPRO_TUNA_CACHE", raising=False)
    tuner.set_default_db(None)
    tuner.set_default_cache(None)
    yield
    tuner.set_default_db(None)
    tuner.set_default_cache(None)


def _rec(op=MM, target=H100, score=1.0, **kw):
    return ScheduleRecord(op=op, target=target,
                          config={"bm": 128, "bn": 128, "bk": 64}, score=score, **kw)


def _srec(op="a[]", target="t0", bm=64, score=1.0):
    return ScheduleRecord(op=op, target=target, config={"bm": bm},
                          score=score, meta={"strategy": "exhaustive"})


def _store_with(tmp_path, name, records):
    db = ScheduleDatabase(str(tmp_path / name))
    for rec in records:
        db.add(rec)
    return db


def _counting(monkeypatch):
    calls = []
    real = cost_model.evaluate

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(cost_model, "evaluate", counting)
    return calls


# --------------------------------------------------------------------------
# the database (tests/test_tuna.py::TestScheduleDatabase)
# --------------------------------------------------------------------------


class TestScheduleDatabase:
    def test_roundtrip_write_reload_query_best(self, tmp_path):
        path = tmp_path / "db.jsonl"
        db = ScheduleDatabase(path)
        db.add(_rec(score=2.0))
        db.add(_rec(score=1.0))            # improves
        db.add(_rec(score=5.0))            # worse: logged, not indexed
        db.add(_rec(op="other[]", score=3.0))
        re = ScheduleDatabase(path)
        assert re.lines_read == 4 and len(re) == 2
        best = re.best(MM, H100)
        assert best is not None and best.score == 1.0
        assert best.config == {"bm": 128, "bn": 128, "bk": 64}
        assert best.version == COST_MODEL_VERSION == "cm1"
        assert re.best("other[]", H100, version="cm0") is None

    def test_corrupt_lines_skipped(self, tmp_path):
        path = tmp_path / "db.jsonl"
        ScheduleDatabase(path).add(_rec(score=1.5))
        with open(path, "a") as f:
            f.write("{not json\n\n")
            f.write(json.dumps({"op": "x"}) + "\n")  # missing fields
        re = ScheduleDatabase(path)
        assert re.corrupt_lines == 2 and len(re) == 1

    def test_compact_drops_superseded_lines(self, tmp_path):
        path = tmp_path / "db.jsonl"
        db = ScheduleDatabase(path)
        for s in (4.0, 3.0, 2.0, 1.0):
            db.add(_rec(score=s))
        db.add(_rec(op="other[]", score=9.0))
        assert db.compact() == 3
        re = ScheduleDatabase(path)
        assert re.lines_read == 2 and len(re) == 2
        assert re.best(MM, H100).score == 1.0

    def test_merge_and_export(self, tmp_path):
        a = ScheduleDatabase(tmp_path / "a.jsonl")
        a.add(_rec(score=2.0))
        b = ScheduleDatabase(tmp_path / "b.jsonl")
        b.add(_rec(score=1.0))                 # beats a's record
        b.add(_rec(op="other[]", score=7.0))   # new key
        b.add(_rec(score=3.0))                 # worse: not absorbed
        assert a.merge(str(tmp_path / "b.jsonl")) == 2
        assert a.best(MM, H100).score == 1.0
        out = tmp_path / "out.json"
        assert a.export(str(out)) == 2
        assert len(json.loads(out.read_text())) == 2

    def test_query_prefix_and_filters(self):
        db = ScheduleDatabase()
        db.add(_rec(score=1.0))
        db.add(_rec(op="matmul[K=512,M=512,N=512,dtype_bytes=2]", score=2.0))
        db.add(_rec(op="flash[d=128,dtype_bytes=2,s=77]", target="t1", score=3.0))
        assert len(db.query(op="matmul")) == 2
        assert len(db.query(target="t1")) == 1
        assert len(db.query()) == 3


# --------------------------------------------------------------------------
# signatures (tests/test_tuna.py::TestSignature), and against the reference
# --------------------------------------------------------------------------


class TestSignature:
    def test_matches_legacy_record_format(self):
        s = MatmulSpace(4096, 4096, 4096, 2, target_kind="sm90")
        assert s.signature() == "matmul[K=4096,M=4096,N=4096,dtype_bytes=2]"
        b = BatchMatmulSpace(8, 128, 128, 64, 4, target_kind="sm90")
        assert b.signature() == "batch_matmul[Bsz=8,K=64,M=128,N=128,dtype_bytes=4]"

    def test_target_kind_not_in_signature(self):
        sm90 = MatmulSpace(256, 256, 256, 4, target_kind="sm90")
        cpu = MatmulSpace(256, 256, 256, 4, target_kind="cpu")
        assert sm90.signature() == cpu.signature()

    @pytest.mark.parametrize("fam,attrs", [
        ("flash", {"s": 77, "d": 128, "dtype_bytes": 2}),
        ("flash", {"s": 2047, "d": 80, "dtype_bytes": 2}),
        ("flash", {"s": 1024, "d": 64}),
        ("flash_gqa", {"s": 512, "d": 64, "hq": 8, "hkv": 2, "causal": True}),
        ("flash_gqa", {"s": 300, "d": 80, "hq": 32, "hkv": 32, "causal": False,
                       "dtype_bytes": 2}),
    ])
    def test_flash_signatures_equal_the_reference(self, fam, attrs):
        from repro.core import op_registry as jop_registry

        for kind in ("tpu", "sm90"):
            port = op_registry.make_space(fam, attrs, kind).signature()
            assert port == jop_registry.make_space(fam, attrs, "tpu").signature()

    def test_sm90_flash_knobs_are_the_built_blocks_at_any_s(self):
        from repro_torch.kernels import flash_attention as fa

        for s in (1, 77, 300, 513, 2047):
            space = op_registry.make_space("flash", {"s": s, "d": 80}, "sm90")
            assert space.knobs == {"block_q": list(fa.BLOCKS),
                                   "block_k": list(fa.BLOCKS)}

    @pytest.mark.parametrize("s", [77, 300, 513, 2047])
    def test_build_flash_counts_ragged_tiles_whole(self, s):
        """The sm90 grid is the kernel's: ceil(S/bq) q-tiles, each over
        ceil(S/bk) kv-tiles."""
        space = op_registry.make_space("flash_gqa", {"s": s, "d": 80, "hq": 32,
                                                     "hkv": 8}, "sm90")
        for cfg in space.enumerate(None):
            prog, meta = space.instantiate(cfg)
            nq, nk = -(-s // cfg["block_q"]), -(-s // cfg["block_k"])
            assert (meta.grid_size, meta.parallel_extent) == (32 * nq * nk, 32 * nq)
            assert prog.roots[0].extent == nq and prog.roots[0].body[0].extent == nk
            assert meta.vmem_tile_bytes == ops.smem_bytes(cfg["block_q"], cfg["block_k"], 80)
            assert cost_model.evaluate(prog, GPU_H100, meta) > 0


# --------------------------------------------------------------------------
# the warm store in the tuner and the pickers (tests/test_tuna.py::TestWarmCache)
# --------------------------------------------------------------------------


class TestWarmCache:
    def test_tune_zero_evaluations_on_warm_db(self, tmp_path, monkeypatch):
        path = str(tmp_path / "db.jsonl")
        space = MatmulSpace(1024, 1024, 1024, 2, target_kind="sm90")
        cold = tuner.tune(space, GPU_H100, db=path)
        assert not cold.from_db and cold.evaluations > 0
        calls = _counting(monkeypatch)
        warm = tuner.tune(MatmulSpace(1024, 1024, 1024, 2, "sm90"), GPU_H100, db=path)
        assert warm.from_db and warm.evaluations == 0 and not calls
        assert warm.config == cold.config and warm.score == cold.score
        assert warm.default_score == cold.default_score

    def test_tune_zero_evaluations_from_snapshot_cache(self, tmp_path, monkeypatch):
        path = str(tmp_path / "db.jsonl")
        space = MatmulSpace(1024, 1024, 1024, 2, target_kind="sm90")
        cold = tuner.tune(space, GPU_H100, db=path)
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(path, snap)
        tuner.set_default_db(None)  # the snapshot serves on its own
        tuner.set_default_cache(snap)
        calls = _counting(monkeypatch)
        warm = tuner.tune(MatmulSpace(1024, 1024, 1024, 2, "sm90"), GPU_H100)
        assert warm.from_db and warm.from_cache and warm.evaluations == 0
        assert not calls and warm.config == cold.config and warm.score == cold.score
        assert tuner.get_default_cache().hits >= 1
        with pytest.raises(TypeError):  # the snapshot never absorbs write-backs
            tuner.get_default_cache().add(None)

    def test_env_cache_pointing_at_unbuilt_snapshot_is_off(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TUNA_CACHE", str(tmp_path / "not_built_yet.json"))
        monkeypatch.setattr(tuner, "_DEFAULT_CACHE", tuner._UNSET)
        assert tuner.get_default_cache() is None
        res = tuner.tune(MatmulSpace(256, 256, 256, 2, "sm90"), GPU_H100, db=False)
        assert not res.from_db and res.evaluations > 0

    def test_flash_blocks_served_from_snapshot_cache(self, tmp_path):
        assert ops.tuned_flash_blocks(2048, 128) == (128, 128)  # the formula's
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        db.add(ScheduleRecord(op="flash[d=128,dtype_bytes=2,s=2048]", target=H100,
                              config={"block_q": 64, "block_k": 64}, score=1e-9))
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(db.path, snap)
        ops.use_schedule_cache(snap)  # clears the memo, installs the cache
        assert ops.tuned_flash_blocks(2048, 128) == (64, 64)
        assert tuner.get_default_cache().hits >= 1

    def test_tuned_matmul_blocks_served_from_default_db(self, tmp_path, monkeypatch):
        path = str(tmp_path / "db.jsonl")
        space = MatmulSpace(2048, 2048, 2048, 2, target_kind="sm90")
        cfg, _ = tuner.best_schedule(space, GPU_H100, db=path)
        tuner.set_default_db(path)  # also clears the lru memo
        calls = _counting(monkeypatch)
        blocks = tuner.tuned_matmul_blocks(2048, 2048, 2048, 2)
        assert blocks == (cfg["bm"], cfg["bn"], cfg["bk"], cfg["double_buffer"])
        assert not calls

    def test_rank_space_writes_back_best(self, tmp_path):
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        space = MatmulSpace(512, 512, 512, 2, target_kind="sm90")
        ranked = tuner.rank_space(space, GPU_H100, limit=1024, db=db)
        rec = db.best(space.signature(), H100)
        assert rec.config == ranked[0][0] and rec.score == ranked[0][1]
        assert rec.meta["strategy"] == "exhaustive" and "tuned_at" in rec.meta
        assert rec.meta["default_score"] == pytest.approx(
            dict((tuple(sorted(c.items())), s) for c, s in ranked)[
                tuple(sorted(space.default_config().items()))])

    def test_env_var_fallback_and_explicit_off(self, tmp_path, monkeypatch):
        path = str(tmp_path / "db.jsonl")
        tuner.tune(MatmulSpace(256, 256, 256, 2, "sm90"), GPU_H100, db=path)
        monkeypatch.setenv("REPRO_TUNA_DB", path)
        monkeypatch.setattr(tuner, "_DEFAULT_DB", tuner._UNSET)
        assert tuner.tune(MatmulSpace(256, 256, 256, 2, "sm90"), GPU_H100).from_db
        tuner.set_default_db(None)  # explicit None: off despite the env var
        assert tuner.get_default_db() is None

    def test_set_default_db_clears_flash_memo(self, tmp_path):
        heuristic = ops.tuned_flash_blocks(1024, 128)  # memoised, no DB
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        db.add(ScheduleRecord(op="flash[d=128,dtype_bytes=2,s=1024]", target=H100,
                              config={"block_q": 64, "block_k": 128}, score=1e-9))
        tuner.set_default_db(db)
        assert ops.tuned_flash_blocks(1024, 128) == (64, 128)
        assert heuristic != (64, 128)  # proves the memo was refreshed

    def test_warm_db_makes_both_pickers_lookups(self, tmp_path, monkeypatch):
        """Cold: an empty DB installed, the pickers at yi-6b's prefill
        lengths and projections write one record per signature (flash
        under ``flash_grid``, matmul under ``exhaustive``), each equal to
        the store-less pick. Warm: the same picks with zero cost-model
        evaluations and no flash candidate scored."""
        lens, shapes = (64, 77, 300, 2047), ((2048, 4096, 4096), (2048, 512, 4096))
        plain_flash = {s: ops.tuned_flash_blocks(s, d, 2) for s in lens for d in (80, 128)}
        plain_mm = {m: tuner.tuned_matmul_blocks(*m) for m in shapes}
        path = str(tmp_path / "db.jsonl")
        ops.use_schedule_db(path)
        assert {s: ops.tuned_flash_blocks(s, d, 2) for s in lens for d in (80, 128)} \
            == plain_flash
        assert {m: tuner.tuned_matmul_blocks(*m) for m in shapes} == plain_mm
        db = ScheduleDatabase(path)
        assert len(db) == len(lens) * 2 + len(shapes) == db.lines_read
        for s in lens:
            for d in (80, 128):
                rec = db.best(f"flash[d={d},dtype_bytes=2,s={s}]", H100)
                assert rec.meta == {"strategy": "flash_grid"} and rec.evaluations == 4
                assert (rec.config["block_q"], rec.config["block_k"]) == plain_flash[s]
        for m, n, k in shapes:
            rec = db.best(f"matmul[K={k},M={m},N={n},dtype_bytes=2]", H100)
            assert tuple(rec.config[x] for x in ("bm", "bn", "bk", "double_buffer")) \
                == plain_mm[(m, n, k)]

        ops.use_schedule_db(path)  # clears the memos: every pick re-resolves
        calls = _counting(monkeypatch)
        monkeypatch.setattr(ops, "smem_bytes", lambda *a: pytest.fail("flash scored"))
        assert {s: ops.tuned_flash_blocks(s, d, 2) for s in lens for d in (80, 128)} \
            == plain_flash
        assert {m: tuner.tuned_matmul_blocks(*m) for m in shapes} == plain_mm
        assert not calls and ScheduleDatabase(path).lines_read == len(db)


# --------------------------------------------------------------------------
# orchestrator and CLI (tests/test_tuna.py::TestOrchestrator, TestCli)
# --------------------------------------------------------------------------


class TestOrchestrator:
    def test_fanout_two_spaces_pool_of_two(self, tmp_path):
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        jobs = orchestrator.jobs_for(["dense_256", "flash_gqa"], [H100], limit=256)
        report = orchestrator.run(jobs, db=db, workers=2)
        assert report.ok and len(report.records) == 2 and len(db) == 2
        for job in jobs:
            space = orchestrator.build_space(job)
            cfg, score = tuner.rank_space(space, GPU_H100, limit=256)[0]
            rec = db.best(space.signature(), H100)
            assert rec.config == cfg and rec.score == pytest.approx(score)
        assert len(ScheduleDatabase(tmp_path / "db.jsonl")) == 2

    def test_failures_reported_after_retries(self):
        db = ScheduleDatabase()
        jobs = [TuneJob(op="no_such_op", target=H100),
                TuneJob(op="dense_256", target=H100, limit=64)]
        report = orchestrator.run(jobs, db=db, workers=1, retries=1)
        assert len(report.records) == 1 and len(report.failures) == 1
        fail = report.failures[0]
        assert fail.job.op == "no_such_op" and fail.attempts == 2
        assert "no_such_op" in fail.error


class TestCli:
    def test_smoke_tune_query_compact_export(self, tmp_path, capsys):
        db = str(tmp_path / "db.jsonl")
        assert cli.main(["tune", "--smoke", "--db", db, "--workers", "1"]) == 0
        assert cli.main(["query", "--db", db, "--target", H100]) == 0
        out = capsys.readouterr().out
        assert "matmul[K=256,M=256,N=256,dtype_bytes=4]" in out
        assert cli.main(["compact", "--db", db]) == 0
        assert cli.main(["export", "--db", db, "--out", str(tmp_path / "out.json")]) == 0
        assert len(json.loads((tmp_path / "out.json").read_text())) == 2
        assert cli.main(["query", "--db", db, "--op", "nope["]) == 1

    @pytest.mark.parametrize("argv", [["--ops", "bogus", "--targets", H100],
                                      ["--ops", "dense_256", "--targets", "tpu_v5e"],
                                      ["--num-shards", "2", "--shard-id", "2"]])
    def test_bad_op_target_or_shard_rejected(self, tmp_path, argv):
        assert cli.main(["tune", "--db", str(tmp_path / "db.jsonl")] + argv) == 2

    def test_snapshot_then_query_the_snapshot(self, tmp_path, capsys):
        db = str(tmp_path / "db.jsonl")
        assert cli.main(["tune", "--db", db, "--ops", "flash_gqa,dense_512",
                         "--workers", "1"]) == 0
        assert cli.main(["snapshot", "--db", db]) == 2  # neither --out nor --dir
        snap = str(tmp_path / "snap.json")
        assert cli.main(["snapshot", "--db", db, "--out", snap]) == 0
        capsys.readouterr()
        assert cli.main(["query", "--snapshot", snap, "--op", "flash_gqa", "--json"]) == 0
        recs = json.loads(capsys.readouterr().out)
        assert [r["op"] for r in recs] == [
            "flash_gqa[causal=True,d=64,dtype_bytes=2,hkv=2,hq=8,s=512]"]
        assert ScheduleCache.load(snap).sha1 == ScheduleCache.from_db(
            ScheduleDatabase(db)).payload_sha1()
        assert cli.main(["query"]) == 2

    def test_db_defaults_to_the_env_variable(self, tmp_path, monkeypatch):
        db = str(tmp_path / "env.jsonl")
        monkeypatch.setenv("REPRO_TUNA_DB", db)
        assert cli.main(["tune", "--ops", "dense_512", "--workers", "1"]) == 0
        assert len(ScheduleDatabase(db)) == 1


# --------------------------------------------------------------------------
# the fleet (tests/test_fleet.py)
# --------------------------------------------------------------------------

JOB_OPS = ["dense_256", "dense_512", "batch_matmul", "depthwise_conv2d", "flash_gqa"]


def _matrix():
    jobs = orchestrator.jobs_for(JOB_OPS, [H100], limit=64)
    jobs += orchestrator.jobs_for(["dense_256"], [H100], strategy="es", limit=64)
    return jobs


def _strip(db):
    return [(r.op, r.target, r.version, json.dumps(r.config, sort_keys=True),
             r.score, r.evaluations, strip_bookkeeping(r.meta))
            for r in db.records()]


class TestShardJobs:
    @pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
    def test_disjoint_and_covering(self, num_shards):
        jobs = _matrix()
        shards = [fleet.shard_jobs(jobs, num_shards, i) for i in range(num_shards)]
        seen = [fleet.job_fingerprint(j) for s in shards for j in s]
        assert sorted(seen) == sorted(fleet.job_fingerprint(j) for j in jobs)
        assert len(set(seen)) == len(jobs)

    def test_stable_across_runs_and_list_order(self):
        jobs = _matrix()
        a = fleet.shard_jobs(jobs, 3, 1)
        b = fleet.shard_jobs(list(reversed(jobs)), 3, 1)
        assert sorted(map(fleet.job_fingerprint, a)) == sorted(map(fleet.job_fingerprint, b))
        assert fleet.shard_jobs(jobs, 3, 1) == a

    def test_invalid_arguments_rejected(self):
        with pytest.raises(ValueError):
            fleet.shard_jobs([], 0, 0)
        with pytest.raises(ValueError):
            fleet.shard_jobs([], 2, 2)

    def test_shard_store_path_derivation(self):
        assert fleet.shard_store_path("db.jsonl", 3) == "db.shard03.jsonl"
        assert fleet.shard_store_path("/x/store", 0) == "/x/store.shard00.jsonl"

    def test_lease_expires_but_heartbeat_keeps_the_deadline(self):
        lease = fleet.ShardLease(shard_id=1, jobs=3, granted_at=100.0, lease_s=10.0)
        lease.heartbeat(now=105.0)
        assert lease.last_heartbeat == 105.0 and lease.deadline == 110.0
        assert not lease.expired(now=110.0) and lease.expired(now=110.5)


class TestFleetEndToEnd:
    def test_three_shard_fleet_matches_single_run(self, tmp_path):
        jobs = _matrix()
        single = ScheduleDatabase(tmp_path / "single.jsonl")
        assert orchestrator.run(jobs, db=single, workers=1).ok
        base = str(tmp_path / "fleet.jsonl")
        partial_run = fleet.run_fleet(jobs, 3, base, workers=1, shard_ids=[0, 1])
        assert partial_run.ok
        partial = fleet.sync(base, 3)
        assert [os.path.basename(p) for p in partial.skipped] == ["fleet.shard02.jsonl"]
        assert fleet.missing_shards(base, 3) == [2]
        assert 0 < partial.keys < len(single)
        resumed = fleet.run_shard(jobs, 3, 2, base, workers=1)
        assert resumed.ok and resumed.jobs > 0
        full = fleet.sync(base, 3)
        assert not full.skipped
        assert fleet.divergence(full.db, single, "fleet", "single") == []
        assert _strip(full.db) == _strip(single)
        origins = {r.meta["provenance"] for r in full.db.records()}
        assert origins <= {f"fleet.shard0{i}.jsonl" for i in range(3)}
        before = open(base, "rb").read()
        fleet.run_shard(jobs, 3, 1, base, workers=1)
        fleet.sync(base, 3)
        assert open(base, "rb").read() == before  # idempotent
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(base, snap)
        assert ScheduleCache.load(snap).records() == full.db.records()


class TestSyncEdgeCases:
    def test_empty_shard_still_leaves_a_store(self, tmp_path):
        jobs = orchestrator.jobs_for(["dense_256"], [H100], limit=64)
        base = str(tmp_path / "fleet.jsonl")
        rep = fleet.run_fleet(jobs, 2, base, workers=1)
        assert rep.ok and sorted(s.jobs for s in rep.shards) == [0, 1]
        srep = fleet.sync(base, 2)
        assert srep.skipped == [] and srep.keys == 1

    def test_provenance_never_decides_a_tie(self, tmp_path):
        recs = [ScheduleRecord(op="a[]", target="t0", config={"bm": 256},
                               score=1.0, meta={"strategy": "es"}),
                ScheduleRecord(op="a[]", target="t0", config={"bm": 64},
                               score=1.0, meta={"strategy": "exhaustive"})]
        paths = [_store_with(tmp_path, f"s{i}.jsonl", [r]).path for i, r in enumerate(recs)]
        winners = set()
        for name, order, prov in [("ab", paths, True), ("ba", paths[::-1], True),
                                  ("np", paths, False)]:
            db = ScheduleDatabase(tmp_path / f"{name}.jsonl")
            db.merge_all(order, provenance=prov)
            winners.add(json.dumps(db.best("a[]", "t0").config))
        assert len(winners) == 1

    def test_divergence_names_what_differs(self, tmp_path):
        a = _store_with(tmp_path, "a.jsonl", [_srec(), _srec(op="b[]")])
        b = _store_with(tmp_path, "b.jsonl", [_srec(bm=128), _srec(op="c[]")])
        msgs = fleet.divergence(a, b)
        assert any("config differs" in m for m in msgs)
        assert any("only in a" in m for m in msgs) and any("only in b" in m for m in msgs)


class TestScheduleCache:
    def _populated_db(self, tmp_path):
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        for op, target, version, score in [
            (MM, H100, "cm1", 2.0), (MM, H100, "cm1", 1.0),
            ("matmul[K=512,M=512,N=512,dtype_bytes=2]", "cpu_avx2", "cm1", 3.0),
            ("matmul[K=512,M=512,N=512,dtype_bytes=2]", "cpu_avx2", "cm1-cal-deadbeef", 4.0),
            ("flash[d=128,dtype_bytes=2,s=1024]", H100, "cm1", 5.0),
        ]:
            db.add(ScheduleRecord(op=op, target=target, version=version,
                                  config={"bm": 128}, score=score,
                                  meta={"strategy": "exhaustive"}))
        return db

    def test_snapshot_roundtrip_matches_live_db(self, tmp_path):
        db = self._populated_db(tmp_path)
        out = str(tmp_path / "cache.json")
        built = ScheduleCache.build(db.path, out)
        loaded = ScheduleCache.load(out)
        assert len(loaded) == len(built) == len(db)
        for rec in db.records():
            assert loaded.best(rec.op, rec.target, rec.version) == rec
        for kw in ({}, {"op": "matmul"}, {"target": "cpu_avx2"},
                   {"version": "cm1-cal-deadbeef"}, {"op": "flash", "target": H100}):
            assert loaded.query(**kw) == db.query(**kw)
        assert loaded.hits == len(db) and loaded.misses == 0
        assert loaded.best("nope[]", H100) is None and loaded.misses == 1

    def test_rebuilt_snapshot_reinstall_serves_new_records(self, tmp_path):
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        db.add(ScheduleRecord(op=MM, target=H100, config={"bm": 64}, score=2.0))
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(db.path, snap)
        tuner.set_default_cache(snap)
        assert tuner.get_default_cache().best(MM, H100).config == {"bm": 64}
        db.add(ScheduleRecord(op=MM, target=H100, config={"bm": 128}, score=1.0))
        ScheduleCache.build(db.path, snap)
        tuner.set_default_cache(snap)
        assert tuner.get_default_cache().best(MM, H100).config == {"bm": 128}

    def test_cache_is_immutable(self, tmp_path):
        db = self._populated_db(tmp_path)
        with pytest.raises(TypeError, match="immutable"):
            ScheduleCache.from_db(db).add(db.records()[0])

    def test_corrupt_snapshot_rejected(self, tmp_path):
        db = self._populated_db(tmp_path)
        out = str(tmp_path / "cache.json")
        ScheduleCache.build(db.path, out)
        blob = open(out).read()
        with open(out, "w") as f:
            f.write(blob.replace('"score": 5.0', '"score": 0.5'))
        with pytest.raises(ValueError, match="digest mismatch"):
            ScheduleCache.load(out)
        with open(out, "w") as f:
            f.write(json.dumps({"schema": "something-else", "records": []}))
        with pytest.raises(ValueError, match="not a schedule snapshot"):
            ScheduleCache.load(out)


# -- cross-process stress (the inode revalidation of db.py), small ----------

def _stress_worker(path: str, wid: int, n: int) -> None:
    db = ScheduleDatabase(path)
    for i in range(n):
        db.add(ScheduleRecord(op=f"op{i % 5}[]", target=f"t{wid}",
                              config={"i": i}, score=float(n - i)))
        if i % 7 == 3:
            db.compact()


class TestCrossProcessStress:
    def test_concurrent_add_and_compact(self, tmp_path):
        path = str(tmp_path / "db.jsonl")
        n, procs_n = 15, 3
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_stress_worker, args=(path, wid, n))
                 for wid in range(procs_n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
            assert p.exitcode == 0
        db = ScheduleDatabase(path)
        assert db.corrupt_lines == 0
        for wid in range(procs_n):
            for k in range(5):
                best = db.best(f"op{k}[]", f"t{wid}")
                assert best.score == float(n - max(i for i in range(n) if i % 5 == k))


# -- retry accounting ---------------------------------------------------------

_FLAKY_DIR_ENV = "REPRO_TEST_FLAKY_DIR"


def _flaky_runner(job: TuneJob) -> ScheduleRecord:
    d = os.environ[_FLAKY_DIR_ENV]
    for i in range(2):
        try:
            fd = os.open(os.path.join(d, f"fail{i}"), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.close(fd)
        raise RuntimeError(f"transient failure {i}")
    return ScheduleRecord(op=f"flaky[{job.op}]", target=job.target, config={}, score=1.0)


def _always_failing_runner(job: TuneJob) -> ScheduleRecord:
    d = os.environ[_FLAKY_DIR_ENV]
    for k in range(1000):
        try:
            fd = os.open(os.path.join(d, f"exec{k}"), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.close(fd)
        raise RuntimeError(f"execution {k} failed")
    raise AssertionError("marker space exhausted")


class TestRetryAccounting:
    def test_duplicate_jobs_do_not_share_retry_budget(self, tmp_path, monkeypatch):
        monkeypatch.setenv(_FLAKY_DIR_ENV, str(tmp_path))
        jobs = [TuneJob(op="dense_256"), TuneJob(op="dense_256")]
        report = orchestrator.run(jobs, workers=2, retries=2, runner=_always_failing_runner)
        assert len([f for f in os.listdir(tmp_path) if f.startswith("exec")]) == 6
        assert [f.attempts for f in report.failures] == [3, 3]

    def test_inline_path_retries_each_duplicate(self, tmp_path, monkeypatch):
        monkeypatch.setenv(_FLAKY_DIR_ENV, str(tmp_path))
        jobs = [TuneJob(op="dense_256"), TuneJob(op="dense_256")]
        report = orchestrator.run(jobs, workers=1, retries=2, runner=_flaky_runner)
        assert report.ok and len(report.records) == 2


# --------------------------------------------------------------------------
# merge algebra (tests/test_merge_properties.py)
# --------------------------------------------------------------------------

SETTINGS = settings(max_examples=15, deadline=None)
records = st.builds(
    ScheduleRecord,
    op=st.sampled_from(["a[]", "b[]"]),
    target=st.sampled_from(["t0", H100]),
    version=st.sampled_from(["cm1", "cm1-cal-x"]),
    config=st.fixed_dictionaries({"bm": st.sampled_from([64, 128, 256])}),
    score=st.sampled_from([1.0, 2.0, 3.0]),
    evaluations=st.integers(min_value=0, max_value=3),
    meta=st.fixed_dictionaries({"strategy": st.sampled_from(["es", "exhaustive"])}),
)
record_lists = st.lists(records, max_size=6)


def _hstore(d, name, recs):
    db = ScheduleDatabase(os.path.join(d, name))
    open(db.path, "a").close()
    for r in recs:
        db.add(r)
    return db.path


def _hmerge(d, name, paths):
    db = ScheduleDatabase(os.path.join(d, name))
    open(db.path, "a").close()
    db.merge_all(paths, provenance=False)
    return db


def _bestset(db):
    return frozenset(r.to_json() for r in db.records())


class TestMergeAlgebra:
    @SETTINGS
    @given(record_lists, record_lists)
    def test_commutative(self, xs, ys):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            pa, pb = _hstore(d, "a", xs), _hstore(d, "b", ys)
            assert _bestset(_hmerge(d, "ab", [pa, pb])) == _bestset(_hmerge(d, "ba", [pb, pa]))

    @SETTINGS
    @given(record_lists, record_lists, record_lists)
    def test_associative(self, xs, ys, zs):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            pa, pb, pc = _hstore(d, "a", xs), _hstore(d, "b", ys), _hstore(d, "c", zs)
            left = _hmerge(d, "l", [_hmerge(d, "ab", [pa, pb]).path, pc])
            right = _hmerge(d, "r", [pa, _hmerge(d, "bc", [pb, pc]).path])
            assert _bestset(left) == _bestset(right)

    @SETTINGS
    @given(record_lists)
    def test_idempotent(self, xs):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            pa = _hstore(d, "a", xs)
            once = _hmerge(d, "m1", [pa])
            assert _bestset(once) == _bestset(_hmerge(d, "m2", [pa, pa]))
            blob = open(once.path, "rb").read()
            assert once.merge(pa, provenance=False) == 0
            assert open(once.path, "rb").read() == blob

    @SETTINGS
    @given(records, records)
    def test_record_order_is_total_and_antisymmetric(self, r1, r2):
        if r1.key != r2.key:
            return
        if r1.to_json() == r2.to_json():
            assert not record_beats(r1, r2) and not record_beats(r2, r1)
        else:
            assert record_beats(r1, r2) != record_beats(r2, r1)

    @SETTINGS
    @given(record_lists)
    def test_port_and_reference_merge_to_the_same_best_set(self, xs):
        """Both packages' total record order: the same shard merged by each
        keeps the same best records, byte for byte."""
        import tempfile

        from repro.tuna.db import ScheduleDatabase as JDatabase

        with tempfile.TemporaryDirectory() as d:
            pa = _hstore(d, "a", xs)
            jdb = JDatabase(os.path.join(d, "j"))
            jdb.merge_all([pa], provenance=False)
            assert _bestset(_hmerge(d, "p", [pa])) == frozenset(
                r.to_json() for r in jdb.records())


# --------------------------------------------------------------------------
# transport and snapshot lifecycle (tests/test_transport.py)
# --------------------------------------------------------------------------


def _mem(tmp_path) -> MemoryTransport:
    bucket = f"torch-test-{os.path.basename(tmp_path)}"
    MemoryTransport.wipe(bucket)
    return MemoryTransport(bucket)


@pytest.fixture(params=["dir", "mem"])
def transport(request, tmp_path):
    if request.param == "dir":
        return LocalDirTransport(str(tmp_path / "bucket"))
    return _mem(tmp_path)


class TestTransportProtocol:
    def test_push_pull_roundtrip_verified(self, transport, tmp_path):
        db = _store_with(tmp_path, "src.jsonl", [_srec(), _srec(op="b[]")])
        man = transport.push(db.path, "fleet.shard00.jsonl")
        assert man.records == 2 and man.size == os.path.getsize(db.path)
        assert man.cost_model_version == COST_MODEL_VERSION
        assert transport.exists("fleet.shard00.jsonl")
        assert transport.list() == ["fleet.shard00.jsonl"]
        assert transport.list_shards("fleet.jsonl") == ["fleet.shard00.jsonl"]
        out = str(tmp_path / "pulled" / "fleet.shard00.jsonl")
        assert transport.pull("fleet.shard00.jsonl", out) == man
        assert open(out, "rb").read() == open(db.path, "rb").read()

    def test_pull_of_corrupt_blob_fails_loudly(self, transport, tmp_path):
        db = _store_with(tmp_path, "src.jsonl", [_srec()])
        transport.push(db.path, "x.jsonl")
        transport._put("x.jsonl", b'{"torn": ')
        with pytest.raises(IntegrityError, match="torn or corrupt"):
            transport.pull("x.jsonl", str(tmp_path / "out.jsonl"))
        assert not os.path.exists(tmp_path / "out.jsonl")

    def test_missing_object_and_manifest(self, transport, tmp_path):
        with pytest.raises(TransportError, match="no object"):
            transport.pull("nope.jsonl", str(tmp_path / "out"))
        transport._put("bare.jsonl", b"{}\n")
        with pytest.raises(TransportError, match="no manifest"):
            transport.pull("bare.jsonl", str(tmp_path / "out"))

    def test_mid_push_blob_is_not_yet_visible(self, transport, tmp_path):
        transport._put("f.shard00.jsonl", b'{"op": "a[]"}\n')
        assert not transport.exists("f.shard00.jsonl")
        rep = fleet.sync(str(tmp_path / "sync" / "f.jsonl"), 1, transport=transport)
        assert rep.skipped == ["f.shard00.jsonl"] and rep.pulled == []

    def test_repush_replaces_payload_and_manifest_coherently(self, transport, tmp_path):
        db = _store_with(tmp_path, "src.jsonl", [_srec()])
        first = transport.push(db.path, "f.shard00.jsonl")
        db.add(_srec(op="more[]", bm=256, score=0.5))
        second = transport.push(db.path, "f.shard00.jsonl")
        assert second.sha1 != first.sha1 and second.records == 2
        out = str(tmp_path / "out.jsonl")
        assert transport.pull("f.shard00.jsonl", out) == second

    def test_memory_buckets_shared_by_name_isolated_by_bucket(self, tmp_path):
        a1, a2, b = (MemoryTransport("tbkt-a"), MemoryTransport("tbkt-a"),
                     MemoryTransport("tbkt-b"))
        try:
            db = _store_with(tmp_path, "s.jsonl", [_srec()])
            a1.push(db.path, "s.jsonl")
            assert a2.exists("s.jsonl") and not b.exists("s.jsonl")
        finally:
            MemoryTransport.wipe("tbkt-a")
            MemoryTransport.wipe("tbkt-b")

    def test_resolve_transport_specs(self, tmp_path):
        assert isinstance(resolve_transport(f"dir://{tmp_path}/bucket"), LocalDirTransport)
        assert resolve_transport(str(tmp_path)).root == str(tmp_path)
        m = resolve_transport("mem://torch-spec-test")
        assert isinstance(m, MemoryTransport) and m.bucket == "torch-spec-test"
        assert resolve_transport(m) is m
        with pytest.raises(ValueError):
            resolve_transport("")

    def test_dir_transport_rejects_escaping_names(self, tmp_path):
        with pytest.raises(TransportError, match="escapes"):
            LocalDirTransport(str(tmp_path / "bucket"))._put("../outside.jsonl", b"x")


class _RepushRacingTransport(MemoryTransport):
    def pull(self, name, local_path):
        self._delete(name + ".manifest")
        return super().pull(name, local_path)


class TestFleetOverTransport:
    def test_sync_skips_shard_repushed_mid_window(self, tmp_path):
        bucket = f"torch-race-{os.path.basename(tmp_path)}"
        MemoryTransport.wipe(bucket)
        db = _store_with(tmp_path, "src.jsonl", [_srec()])
        _RepushRacingTransport(bucket).push(db.path, "f.shard00.jsonl")
        rep = fleet.sync(str(tmp_path / "sync" / "f.jsonl"), 1,
                         transport=_RepushRacingTransport(bucket))
        assert rep.skipped == ["f.shard00.jsonl"] and rep.pulled == []
        clean = MemoryTransport(bucket)
        clean.push(db.path, "f.shard00.jsonl")
        clean._put("f.shard00.jsonl", b"bitrot")
        with pytest.raises(IntegrityError):
            fleet.sync(str(tmp_path / "sync2" / "f.jsonl"), 1, transport=clean)
        MemoryTransport.wipe(bucket)

    def test_unsharded_tune_push_is_reachable_by_sync(self, tmp_path, capsys):
        bucket = f"mem://torch-cli-{os.path.basename(tmp_path)}"
        MemoryTransport.wipe(bucket[len("mem://"):])
        db = str(tmp_path / "host" / "db.jsonl")
        assert cli.main(["tune", "--smoke", "--workers", "1", "--db", db,
                         "--transport", bucket]) == 0
        assert "pushed db.shard00.jsonl" in capsys.readouterr().out
        rep = fleet.sync(str(tmp_path / "sync" / "db.jsonl"), 1, transport=bucket)
        assert rep.pulled == ["db.shard00.jsonl"] and rep.keys == len(ScheduleDatabase(db))

    def test_two_shard_fleet_no_shared_fs_matches_single_run(self, tmp_path):
        jobs = orchestrator.jobs_for(JOB_OPS, [H100], limit=64)
        single = ScheduleDatabase(str(tmp_path / "single.jsonl"))
        assert orchestrator.run(jobs, db=single, workers=1).ok
        t = _mem(tmp_path)
        ids = sorted({fleet.shard_of(j, 2) for j in jobs})
        assert ids == [0, 1]
        a = fleet.run_shard(jobs, 2, 0, str(tmp_path / "hostA" / "f.jsonl"),
                            transport=t, workers=1)
        assert a.ok and a.pushed.name == "f.shard00.jsonl"
        sync_base = str(tmp_path / "hostC" / "f.jsonl")
        partial = fleet.sync(sync_base, 2, transport=t)
        assert partial.skipped == ["f.shard01.jsonl"] and partial.pulled == ["f.shard00.jsonl"]
        b = fleet.run_shard(jobs, 2, 1, str(tmp_path / "hostB" / "f.jsonl"),
                            transport=t, workers=1)
        assert b.ok
        full = fleet.sync(sync_base, 2, transport=t)
        assert full.skipped == [] and full.corrupt_lines == 0
        assert fleet.divergence(full.db, single, "fleet", "single") == []
        assert fleet.sync(sync_base, 2, transport=t).db.records() == full.db.records()


def _locked_slow_writer(path: str, line: str, hold_seconds: float) -> None:
    import fcntl

    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    half = len(line) // 2
    os.write(fd, line[:half].encode())
    with open(path + ".lock-held", "w"):
        pass
    time.sleep(hold_seconds)
    os.write(fd, line[half:].encode())
    os.close(fd)


class TestMergeUnderConcurrentAppend:
    def test_locked_merge_waits_for_inflight_writer(self, tmp_path):
        base = str(tmp_path / "f.jsonl")
        shard = fleet.shard_store_path(base, 0)
        keep = _srec(op="keep[]", bm=128, score=0.5)
        ScheduleDatabase(shard).add(_srec(op="first[]"))
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(target=_locked_slow_writer,
                           args=(shard, keep.to_json() + "\n", 0.5))
        proc.start()
        try:
            deadline = time.monotonic() + 60
            while not os.path.exists(shard + ".lock-held"):
                assert time.monotonic() < deadline, "writer never locked"
                time.sleep(0.01)
            rep = fleet.sync(base, 1)
        finally:
            proc.join(timeout=60)
        assert proc.exitcode == 0 and rep.corrupt_lines == 0
        assert rep.db.best("keep[]", "t0").config == {"bm": 128}

    def test_torn_line_reported_then_recovered_by_resync(self, tmp_path):
        base = str(tmp_path / "f.jsonl")
        shard = fleet.shard_store_path(base, 0)
        good, torn = _srec(op="good[]"), _srec(op="late[]", bm=256, score=0.25)
        with open(shard, "w") as f:
            f.write(good.to_json() + "\n" + torn.to_json()[:20])
        rep = fleet.sync(base, 1)
        assert rep.corrupt_lines == 1 and rep.corrupt[shard] == 1
        assert rep.db.best("late[]", "t0") is None
        with open(shard, "w") as f:
            f.write(good.to_json() + "\n" + torn.to_json() + "\n")
        rep2 = fleet.sync(base, 1)
        assert rep2.corrupt_lines == 0 and rep2.db.best("late[]", "t0").config == {"bm": 256}

    def test_cli_verify_fails_on_corrupt_lines(self, tmp_path, capsys):
        ref = _store_with(tmp_path, "ref.jsonl", [_srec(op="good[]")])
        base = str(tmp_path / "f.jsonl")
        with open(fleet.shard_store_path(base, 0), "w") as f:
            f.write(_srec(op="good[]").to_json() + "\n" + '{"op": "torn')
        rc = cli.main(["sync", "--db", base, "--num-shards", "1", "--verify", ref.path])
        err = capsys.readouterr().err
        assert rc == 1 and "corrupt" in err and "not lossless" in err

    def test_compact_refuses_bare_shard_siblings(self, tmp_path, capsys):
        base = str(tmp_path / "f.jsonl")
        _store_with(tmp_path, "f.jsonl", [_srec()])
        _store_with(tmp_path, "f.shard00.jsonl", [_srec(op="b[]")])
        assert cli.main(["compact", "--db", base]) == 2
        assert "per-shard store" in capsys.readouterr().err
        assert cli.main(["compact", "--db", base, "--ignore-shards"]) == 0


class TestAppendRetryCap:
    def test_vanishing_store_path_surfaces_instead_of_spinning(self, tmp_path, monkeypatch):
        db = ScheduleDatabase(str(tmp_path / "db.jsonl"))
        db.add(_srec())
        real_stat = os.stat

        def vanishing_stat(path, *args, **kwargs):
            if os.fspath(path) == db.path:
                raise FileNotFoundError(path)
            return real_stat(path, *args, **kwargs)

        monkeypatch.setattr(os, "stat", vanishing_stat)
        with pytest.raises(RuntimeError, match="keeps vanishing"):
            db.add(_srec(op="b[]"))


def _make_stale(snap_path: str, out_path: str, version: str = "cm0") -> str:
    with open(snap_path) as f:
        obj = json.load(f)
    obj["cost_model_version"] = version
    with open(out_path, "w") as f:
        json.dump(obj, f)
    return out_path


class TestStaleSnapshot:
    def _snapshot(self, tmp_path):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]", bm=128)])
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(db.path, snap)
        return snap

    def test_load_rejects_version_mismatch(self, tmp_path):
        stale = _make_stale(self._snapshot(tmp_path), str(tmp_path / "stale.json"))
        with pytest.raises(StaleSnapshotError) as ei:
            ScheduleCache.load(stale)
        msg = str(ei.value)
        assert "cm0" in msg and COST_MODEL_VERSION in msg
        assert "repro_torch.tuna snapshot" in msg

    def test_allow_stale_warns_and_flags(self, tmp_path):
        stale = _make_stale(self._snapshot(tmp_path), str(tmp_path / "stale.json"))
        with pytest.warns(StaleSnapshotWarning):
            cache = ScheduleCache.load(stale, allow_stale=True)
        assert cache.stale and cache.cost_model_version == "cm0" and len(cache) == 1

    def test_set_default_cache_refuses_stale_install(self, tmp_path):
        stale = _make_stale(self._snapshot(tmp_path), str(tmp_path / "stale.json"))
        with pytest.raises(StaleSnapshotError):
            tuner.set_default_cache(stale)
        assert tuner.get_default_cache() is None

    def test_env_cache_stale_flags_then_heals_on_republish(self, tmp_path, monkeypatch):
        snap = self._snapshot(tmp_path)
        served = str(tmp_path / "served.json")
        _make_stale(snap, served)
        monkeypatch.setenv("REPRO_TUNA_CACHE", served)
        monkeypatch.setattr(tuner, "_DEFAULT_CACHE", tuner._UNSET)
        monkeypatch.setattr(tuner, "_DEFAULT_CACHE_PATH", None)
        with pytest.warns(StaleSnapshotWarning, match="REPRO_TUNA_CACHE"):
            assert tuner.get_default_cache() is None
        ScheduleCache.build(str(tmp_path / "db.jsonl"), served)
        assert tuner.refresh_default_cache() is True
        assert tuner.get_default_cache().best("m[]", "t0") is not None

    def test_cli_query_stale_fails_with_actionable_message(self, tmp_path, capsys):
        stale = _make_stale(self._snapshot(tmp_path), str(tmp_path / "stale.json"))
        assert cli.main(["query", "--snapshot", stale, "--op", "m"]) == 1
        err = capsys.readouterr().err
        assert "cm0" in err and "Rebuild" in err

    def test_cli_query_allow_stale_serves_and_warns(self, tmp_path, capsys):
        stale = _make_stale(self._snapshot(tmp_path), str(tmp_path / "stale.json"))
        with pytest.warns(StaleSnapshotWarning):
            rc = cli.main(["query", "--snapshot", stale, "--op", "m", "--allow-stale"])
        out = capsys.readouterr()
        assert rc == 0 and "m[]" in out.out and "WARNING" in out.err


class TestContentDigestRevalidation:
    @pytest.mark.parametrize("stamps", [(1792219006.5, 1792219007.125),
                                        (1792219006.0, 1792219006.25),
                                        (1792219006.123, 1792219007.1)])
    def test_preserved_mtime_and_size_still_reloads(self, tmp_path, monkeypatch, stamps):
        """A republish of an equal-size payload whose file keeps its mtime
        is seen, whatever the digit counts of the two build stamps: the
        stamp is written at a fixed width, so the sizes are equal, and
        revalidation reads the stored payload digest."""
        db_a = _store_with(tmp_path, "db_a.jsonl", [_srec(op="m[]", bm=128, score=1.0)])
        db_b = _store_with(tmp_path, "db_b.jsonl", [_srec(op="m[]", bm=256, score=2.0)])
        snap = str(tmp_path / "cache.json")
        clock = iter(stamps)
        monkeypatch.setattr(cache_mod.time, "time", lambda: next(clock))
        ScheduleCache.build(db_a.path, snap)
        st_a = os.stat(snap)
        tuner.set_default_cache(snap)
        assert tuner.get_default_cache().best("m[]", "t0").config == {"bm": 128}
        ScheduleCache.build(db_b.path, snap)
        os.utime(snap, ns=(st_a.st_atime_ns, st_a.st_mtime_ns))
        now = os.stat(snap)
        assert (now.st_mtime_ns, now.st_size) == (st_a.st_mtime_ns, st_a.st_size)
        assert read_snapshot_header(snap)["built_at"] == round(stamps[1], 3)
        assert tuner.refresh_default_cache() is True
        cache = tuner.get_default_cache()
        assert cache.best("m[]", "t0").config == {"bm": 256} and cache.hits == 1

    def test_refresh_is_noop_without_change(self, tmp_path):
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(_store_with(tmp_path, "db.jsonl", [_srec()]).path, snap)
        tuner.set_default_cache(snap)
        first = tuner.get_default_cache()
        assert tuner.refresh_default_cache() is False
        assert tuner.get_default_cache() is first

    def test_refresh_survives_vanished_snapshot(self, tmp_path):
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(_store_with(tmp_path, "db.jsonl", [_srec()]).path, snap)
        tuner.set_default_cache(snap)
        first = tuner.get_default_cache()
        os.unlink(snap)
        assert tuner.refresh_default_cache() is False
        assert tuner.get_default_cache() is first

    def test_header_probe_matches_full_parse(self, tmp_path):
        snap = str(tmp_path / "cache.json")
        built = ScheduleCache.build(_store_with(
            tmp_path, "db.jsonl", [_srec(op=f"op{i}[]") for i in range(40)]).path, snap)
        hdr = read_snapshot_header(snap)
        assert hdr["sha1"] == built.payload_sha1() and hdr["count"] == 40
        assert hdr["cost_model_version"] == COST_MODEL_VERSION
        assert hdr["built_at"] == built.built_at


class TestSnapshotManager:
    def test_ensure_is_content_addressed_and_idempotent(self, tmp_path):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]")])
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        info = mgr.ensure()
        assert info.rebuilt and info.repointed
        assert COST_MODEL_VERSION in info.name and info.sha1[:12] in info.name
        assert read_snapshot_header(mgr.latest_path)["snapshot"] == info.name
        again = mgr.ensure()
        assert not again.rebuilt and not again.repointed and again.name == info.name
        db.add(_srec(op="n[]", bm=256, score=0.5))
        moved = mgr.ensure()
        assert moved.rebuilt and moved.repointed and moved.name != info.name
        assert os.path.exists(info.path)

    def test_cost_model_bump_retires_the_snapshot_name(self, tmp_path, monkeypatch):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]")])
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        old = mgr.ensure()
        monkeypatch.setattr(cache_mod, "COST_MODEL_VERSION", "cm2")
        bumped = mgr.ensure()
        assert bumped.rebuilt and bumped.repointed
        assert ".cm2-" in bumped.name and bumped.name != old.name
        assert read_snapshot_header(mgr.latest_path)["cost_model_version"] == "cm2"

    def test_load_follows_latest_pointer(self, tmp_path):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]", bm=128)])
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        mgr.ensure()
        assert ScheduleCache.load(mgr.latest_path).best("m[]", "t0").config == {"bm": 128}
        assert read_snapshot_header(mgr.latest_path)["schema"] == POINTER_SCHEMA

    def test_hot_reload_through_latest_pointer(self, tmp_path):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]", bm=128)])
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        mgr.ensure()
        tuner.set_default_cache(mgr.latest_path)
        assert tuner.refresh_default_cache() is False
        db.add(_srec(op="m[]", bm=512, score=0.1))
        mgr.ensure()
        assert tuner.refresh_default_cache() is True
        assert tuner.get_default_cache().best("m[]", "t0").config == {"bm": 512}

    def test_publish_reuses_ensure_info(self, tmp_path, monkeypatch):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]")])
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        info = mgr.ensure()
        monkeypatch.setattr(mgr, "ensure", lambda *a, **k: pytest.fail("rebuilt twice"))
        assert mgr.publish(_mem(tmp_path), info=info)[0].name == info.name

    def test_publish_roundtrip_serves_identically(self, tmp_path):
        db = _store_with(tmp_path, "db.jsonl", [_srec(op="m[]"), _srec(op="n[]", bm=256)])
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        t = _mem(tmp_path)
        manifests = mgr.publish(t)
        assert [m.name for m in manifests] == [mgr.ensure().name, "schedule_cache.latest.json"]
        host = tmp_path / "servehost"
        t.pull("schedule_cache.latest.json", str(host / "schedule_cache.latest.json"))
        target = read_snapshot_header(str(host / "schedule_cache.latest.json"))["snapshot"]
        t.pull(target, str(host / target))
        cache = ScheduleCache.load(str(host / "schedule_cache.latest.json"))
        assert cache.records() == ScheduleCache.from_db(db).records()


# --------------------------------------------------------------------------
# the two packages against each other
# --------------------------------------------------------------------------


def _mixed_records():
    """Records of both packages' targets, several cost-model versions, a
    superseded score and an exact score tie (broken canonically)."""
    return [
        ScheduleRecord(op=MM, target=H100, config={"bm": 128, "bn": 256, "bk": 64,
                                                   "double_buffer": True},
                       score=2e-5, evaluations=24, meta={"strategy": "exhaustive"}),
        ScheduleRecord(op=MM, target=H100, config={"bm": 64, "bn": 64, "bk": 64,
                                                   "double_buffer": False},
                       score=3e-5, evaluations=24, meta={"strategy": "es"}),
        ScheduleRecord(op=MM, target="tpu_v5e", config={"bm": 256, "bn": 256, "bk": 256,
                                                        "double_buffer": True},
                       score=1e-5, evaluations=48,
                       meta={"strategy": "exhaustive", "tuned_at": 1792219006.5}),
        ScheduleRecord(op="flash[d=80,dtype_bytes=2,s=300]", target=H100,
                       config={"block_q": 128, "block_k": 128}, score=4e-6,
                       evaluations=4, meta={"strategy": "flash_grid"}),
        ScheduleRecord(op="flash[d=80,dtype_bytes=2,s=300]", target=H100,
                       config={"block_q": 64, "block_k": 64}, score=4e-6,
                       evaluations=4, meta={"strategy": "flash_grid"}),
        ScheduleRecord(op="conv2d[Cin=64]", target="cpu_avx2", config={"bm": 8},
                       score=0.5, version="cm1-cal-deadbeef"),
    ]


def _as_dicts(store):
    return [dataclasses.asdict(r) for r in store.records()]


class TestAgainstTheReference:
    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_db_and_snapshot_load_in_the_other_package(self, tmp_path, writer):
        from repro.tuna import cache as jcache
        from repro.tuna import db as jdb

        mods = {"reference": (jdb, jcache), "port": (db_mod, cache_mod)}
        (w_db, w_cache), (r_db, r_cache) = (
            mods[writer], mods["port" if writer == "reference" else "reference"])
        path = str(tmp_path / "db.jsonl")
        wdb = w_db.ScheduleDatabase(path)
        for rec in _mixed_records():
            wdb.add(w_db.ScheduleRecord(**dataclasses.asdict(rec)))
        rdb = r_db.ScheduleDatabase(path)
        assert _as_dicts(rdb) == _as_dicts(wdb) and rdb.corrupt_lines == 0
        assert len(rdb) == 4
        snap = str(tmp_path / "snap.json")
        built = w_cache.ScheduleCache.build(path, snap)
        loaded = r_cache.ScheduleCache.load(snap)
        assert _as_dicts(loaded) == _as_dicts(built) == _as_dicts(rdb)
        assert loaded.sha1 == built.payload_sha1()
        for rec in rdb.records():
            assert loaded.best(rec.op, rec.target, rec.version).config == rec.config

    def test_the_same_payload_sha1_from_both(self, tmp_path):
        from repro.tuna.cache import ScheduleCache as JCache
        from repro.tuna.db import ScheduleDatabase as JDatabase

        db = _store_with(tmp_path, "db.jsonl", _mixed_records())
        port_sha = ScheduleCache.from_db(ScheduleDatabase(db.path)).payload_sha1()
        ref_sha = JCache.from_db(JDatabase(db.path)).payload_sha1()
        assert port_sha == ref_sha
        ScheduleCache.build(db.path, str(tmp_path / "p.json"))
        JCache.build(db.path, str(tmp_path / "j.json"))
        assert read_snapshot_header(str(tmp_path / "p.json"))["sha1"] == \
            read_snapshot_header(str(tmp_path / "j.json"))["sha1"] == port_sha

    def test_latest_pointer_written_by_the_port_is_followed_by_the_reference(self, tmp_path):
        from repro.tuna.cache import ScheduleCache as JCache

        db = _store_with(tmp_path, "db.jsonl", _mixed_records())
        mgr = SnapshotManager(db.path, str(tmp_path / "snaps"))
        info = mgr.ensure()
        assert JCache.load(mgr.latest_path).payload_sha1() == info.sha1

    def test_one_file_serves_both_tuners_by_target(self, tmp_path):
        """The reference and the port tune into one store; each tuner's
        warm lookup finds its own target's record."""
        from repro.core import tuner as jtuner
        from repro.core.spaces import MatmulSpace as JMatmulSpace
        from repro.hw import get_target as jget_target

        path = str(tmp_path / "shared.jsonl")
        tpu = jget_target("tpu_v5e")
        jbest = jtuner.best_schedule(JMatmulSpace(512, 512, 512, 2, "tpu"), tpu, db=path)
        pbest = tuner.best_schedule(MatmulSpace(512, 512, 512, 2, "sm90"), GPU_H100, db=path)
        tuner._PATH_DBS.clear()
        sig = "matmul[K=512,M=512,N=512,dtype_bytes=2]"
        both = ScheduleDatabase(path)
        assert {r.target for r in both.query(op=sig)} == {"tpu_v5e", H100}
        assert tuner.lookup_best(sig, H100, db=path).config == pbest[0]
        assert both.best(sig, "tpu_v5e").config == jbest[0]

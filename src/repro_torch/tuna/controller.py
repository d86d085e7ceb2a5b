"""Fleet controller daemon — autonomous tuning as a long-running service
(the port's own copy of ``repro.tuna.controller``; static, no card).

Tuna's cost model needs no target hardware in the loop, so the tuning fleet
is a pure software service; what was missing is the *operator*: today a
human runs ``tune``/``sync``/``snapshot`` by hand. ``FleetController`` is
that operator as a daemon (the AutoTVM tracker/worker split, MITuna's
machine-management interface), keeping the store, snapshots, and serving
hosts converged with no manual steps:

1. **Dispatch** — the (op × target × strategy) job matrix is sharded by
   ``fleet.shard_jobs`` and each shard is handed to a worker (a
   ``python -m repro_torch.tuna tune`` subprocess, or an in-process thread when
   the channel is in-process ``mem://``) under a ``fleet.ShardLease``:
   worker liveness is the heartbeat, the lease deadline bounds how long a
   wedged worker can sit on a shard.
2. **Heal** — a worker that exits without publishing its store (crash) or
   outlives its lease (hang → killed) loses the shard; the controller
   re-dispatches it, up to ``max_attempts`` per shard. Detection reuses
   ``sync``'s crash-skip probe (``fleet.shard_present``: the store
   file/manifest is the commit marker). Because tuning is a pure function
   of the job matrix, a zombie worker finishing late is harmless — its
   records merge idempotently.
3. **Reconcile** — after every change, ``fleet.sync`` merges the shard
   stores, then the controller re-verifies the merge the way
   ``sync --verify`` does: a fresh in-memory merge of the same sources
   must agree with the on-disk store (divergence → gauge + log, corrupt
   source lines → not converged).
4. **Publish** — ``SnapshotManager.ensure``/``publish`` run exactly when
   the merged store or ``COST_MODEL_VERSION`` changed (content-addressed
   no-op otherwise), so serving hosts' ``refresh_default_cache()`` polls
   pick the new snapshot up automatically.
5. **Serve** — a stdlib ``http.server`` endpoint (no new dependencies):
   ``GET /schedule?op=&target=&version=`` answers best-record lookups
   from the live snapshot with the same serialization as
   ``python -m repro_torch.tuna query --json``; ``GET /healthz`` reports
   convergence; ``GET /metrics`` exposes Prometheus text counters/gauges
   (jobs dispatched/done/failed/healed, lease expiries, store record
   count and lag, snapshot age and digest, sync divergence).

Run it: ``python -m repro_torch.tuna controller --db fleet.jsonl --smoke
--num-shards 2 --transport dir:///var/tuna/bucket --publish
dir:///var/tuna/bucket --port 8787``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Set
from urllib.parse import parse_qs, urlparse

from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.tuna import fleet, orchestrator
from repro_torch.tuna.cache import ScheduleCache, SnapshotManager
from repro_torch.tuna.db import ScheduleDatabase, record_to_dict
from repro_torch.tuna.fleet import ShardLease
from repro_torch.tuna.orchestrator import TuneJob


# -- metrics ---------------------------------------------------------------

class ControllerMetrics:
    """Prometheus-text metrics registry (stdlib only). Counters are plain
    ints mutated under the GIL — same discipline as ``ScheduleCache``'s
    hit/miss counters; gauges are recomputed by the controller before each
    render."""

    SPEC = (
        ("jobs_dispatched_total", "counter",
         "Tuning jobs handed to workers (heal re-dispatches included)."),
        ("jobs_done_total", "counter",
         "Tuning jobs completed by a worker that published its store."),
        ("jobs_failed_total", "counter",
         "Tuning jobs on dispatches that crashed or lost their lease."),
        ("jobs_healed_total", "counter",
         "Tuning jobs re-dispatched after a crashed/expired shard."),
        ("shards_healed_total", "counter",
         "Shards re-dispatched after a crash or lease expiry."),
        ("lease_expiries_total", "counter",
         "Shard leases that expired (worker killed, shard re-dispatched)."),
        ("sync_runs_total", "counter",
         "Reconcile rounds (fleet.sync + merge verification)."),
        ("snapshot_rebuilds_total", "counter",
         "Snapshot ensure() calls that wrote a new versioned artifact."),
        ("snapshot_publishes_total", "counter",
         "Snapshots pushed over the publish transport."),
        ("learned_retrains_total", "counter",
         "Learned-ranker ensure() calls that fitted a new artifact "
         "(store training content or cost-model version changed)."),
        ("learned_publishes_total", "counter",
         "Learned-ranker artifacts pushed over the publish transport."),
        ("rounds_total", "counter", "Controller loop iterations."),
        ("store_records", "gauge",
         "Best-record count of the merged store after the last sync."),
        ("store_lag_seconds", "gauge",
         "Seconds since the newest meta.tuned_at in the merged store "
         "(-1 until a stamped record lands)."),
        ("snapshot_age_seconds", "gauge",
         "Seconds since the published snapshot was built (-1 before the "
         "first snapshot)."),
        ("sync_divergence", "gauge",
         "Best-record divergences between the merged store and a fresh "
         "re-merge of the same sources (0 = merge verified)."),
        ("sync_corrupt_lines", "gauge",
         "Corrupt/torn source lines dropped by the last sync."),
        ("active_leases", "gauge", "Shards currently leased to workers."),
        ("shards_done", "gauge", "Shards whose stores have been published."),
        ("shards_failed", "gauge",
         "Shards given up after max_attempts dispatches."),
        ("shards_total", "gauge", "Fleet width (num_shards)."),
    )

    def __init__(self):
        self._v: Dict[str, float] = {name: 0 for name, _, _ in self.SPEC}

    def inc(self, name: str, n: float = 1) -> None:
        self._v[name] += n

    def set(self, name: str, value: float) -> None:
        self._v[name] = value

    def get(self, name: str) -> float:
        return self._v[name]

    @staticmethod
    def _fmt(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else f"{v:.3f}"

    def render(self, info: Optional[Dict[str, str]] = None) -> str:
        lines: List[str] = []
        for name, kind, help_ in self.SPEC:
            full = f"tuna_{name}"
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {kind}")
            lines.append(f"{full} {self._fmt(self._v[name])}")
        if info:
            labels = ",".join(f'{k}="{v}"' for k, v in sorted(info.items()))
            lines.append("# HELP tuna_snapshot_info Identity of the "
                         "snapshot currently served (digest, cost-model "
                         "version).")
            lines.append("# TYPE tuna_snapshot_info gauge")
            lines.append(f"tuna_snapshot_info{{{labels}}} 1")
        return "\n".join(lines) + "\n"


# -- workers ---------------------------------------------------------------

class SubprocessWorker:
    """A shard worker as a child process (the production mode): the
    ordinary ``python -m repro_torch.tuna tune`` CLI tunes the shard slice and
    pushes/writes its store. Process liveness is the heartbeat."""

    def __init__(self, argv: Sequence[str], env: Optional[Dict] = None):
        self.proc = subprocess.Popen(list(argv), env=env)

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        if self.proc.poll() is not None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass

    def describe(self) -> str:
        return f"pid {self.proc.pid}"


class ThreadWorker:
    """A shard worker as an in-process daemon thread — used when the fleet
    channel is in-process (``mem://``) and by tests. ``fn(cancelled)``
    returns truthy/None for success; exceptions report exit code 1.

    Threads cannot be killed: ``kill()`` sets the cooperative ``cancelled``
    event and *abandons* the thread, reporting exit -9. An abandoned worker
    that later finishes anyway only pushes records a re-dispatched worker
    will push identically (tuning is pure), and the merge's total record
    order absorbs duplicates as a no-op."""

    def __init__(self, fn: Callable):
        self.cancelled = threading.Event()
        self._code: Optional[int] = None
        self._killed = False

        def _run():
            try:
                ok = fn(self.cancelled)
                self._code = 0 if ok is None or ok else 2
            except BaseException:  # noqa: BLE001 — worker crash, not ours
                self._code = 1

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def poll(self) -> Optional[int]:
        if self._killed:
            return -9
        if self._thread.is_alive():
            return None
        return self._code if self._code is not None else 1

    def kill(self) -> None:
        self._killed = True
        self.cancelled.set()

    def describe(self) -> str:
        return f"thread {self._thread.name}"


# -- the controller --------------------------------------------------------

@dataclasses.dataclass
class ControllerConfig:
    db: str
    ops: Sequence[str]
    targets: Sequence[str]
    num_shards: int = 2
    strategy: str = "exhaustive"
    limit: int = 256
    seed: int = 0
    transport: Optional[object] = None   # spec string or Transport instance
    snapshot_dir: Optional[str] = None   # default: <db>.snapshots/
    publish: Optional[object] = None     # transport the snapshots go out on
    learned_dir: Optional[str] = None    # retrain + republish the learned
    #   ranker into this directory on store content change (None = off)
    lease_s: float = 300.0
    poll_s: float = 0.5
    max_attempts: int = 3                # dispatches per shard before giving up
    max_workers: int = 2                 # concurrent shard workers
    worker_procs: int = 2                # orchestrator pool inside a worker
    worker_retries: int = 2
    worker_mode: str = "auto"            # auto | process | thread
    inject_crash_shard: Optional[int] = None  # fault injection: this
    #   shard's FIRST dispatch dies before publishing (CI heal check)
    quiet: bool = False


class FleetController:
    """The autonomous tune → heal → sync → snapshot loop (see module
    docstring). Construct, then either call ``step()`` yourself (tests,
    benchmarks) or ``run()`` for the daemon loop; ``start_http`` serves
    the query/health/metrics API from any thread."""

    def __init__(self, cfg: ControllerConfig,
                 jobs: Optional[Sequence[TuneJob]] = None,
                 worker_factory: Optional[Callable] = None):
        if cfg.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {cfg.num_shards}")
        self.cfg = cfg
        self.jobs = list(jobs) if jobs is not None else orchestrator.jobs_for(
            cfg.ops, cfg.targets, strategy=cfg.strategy, limit=cfg.limit,
            seed=cfg.seed)
        self.transport = None
        if cfg.transport is not None:
            from repro_torch.tuna.transport import resolve_transport

            self.transport = resolve_transport(cfg.transport)
        self.snapshot_dir = cfg.snapshot_dir or os.fspath(cfg.db) + \
            ".snapshots"
        self.manager = SnapshotManager(cfg.db, self.snapshot_dir)
        self.learned_manager = None
        if cfg.learned_dir:
            from repro_torch.tuna.learned import LearnedManager

            self.learned_manager = LearnedManager(cfg.db, cfg.learned_dir)
        self._learned_info = None
        self._published_learned_sha: Optional[str] = None
        self.metrics = ControllerMetrics()
        self.metrics.set("shards_total", cfg.num_shards)
        self.leases: Dict[int, ShardLease] = {}
        self.attempts: Dict[int, int] = {i: 0 for i in range(cfg.num_shards)}
        self.done: Set[int] = set()
        self.given_up: Set[int] = set()
        self.events: List[Dict] = []  # timestamped dispatch/heal/fail log
        self.rounds = 0
        self._worker_factory = worker_factory or self._default_worker
        self._stop = threading.Event()
        self._dirty = True           # store may be ahead of the last sync
        self._last_sync: Optional[fleet.SyncReport] = None
        self._last_sync_clean = False
        self._store_records = 0
        self._last_tuned_at: Optional[float] = None
        self._snapshot_info = None
        self._published_sha: Optional[str] = None
        self._cache: Optional[ScheduleCache] = None
        self._shard_jobs = {
            i: len(fleet.shard_jobs(self.jobs, cfg.num_shards, i))
            for i in range(cfg.num_shards)
        }
        # resume support: shards already published (a previous controller
        # run, or hand-run `tune` hosts) are done — the manifest/store file
        # is the commit marker, exactly as sync sees it
        for sid in range(cfg.num_shards):
            if fleet.shard_present(cfg.db, sid, transport=self.transport):
                self.done.add(sid)
                self._event("resumed", sid, "store already present")

    # -- logging / events ------------------------------------------------

    def _log(self, msg: str) -> None:
        if not self.cfg.quiet:
            print(f"[controller] {msg}", flush=True)

    def _event(self, kind: str, shard: int, detail: str = "") -> None:
        self.events.append({"t": time.time(), "event": kind, "shard": shard,
                            "detail": detail})

    # -- worker dispatch --------------------------------------------------

    def _thread_mode(self) -> bool:
        if self.cfg.worker_mode != "auto":
            return self.cfg.worker_mode == "thread"
        from repro_torch.tuna.transport import MemoryTransport

        return isinstance(self.transport, MemoryTransport)

    def _worker_env(self) -> Dict[str, str]:
        """Child env with the ``repro_torch`` package importable even when
        the controller was launched from somewhere else."""
        import repro_torch

        # a namespace package has no __file__: locate the src dir from
        # __path__ instead
        pkg_dir = (os.path.dirname(repro_torch.__file__)
                   if getattr(repro_torch, "__file__", None)
                   else list(repro_torch.__path__)[0])
        src = os.path.dirname(os.path.abspath(pkg_dir))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return env

    def _worker_argv(self, shard_id: int) -> List[str]:
        cfg = self.cfg
        argv = [sys.executable, "-m", "repro_torch.tuna", "tune",
                "--db", os.fspath(cfg.db),
                "--num-shards", str(cfg.num_shards),
                "--shard-id", str(shard_id), "--as-shard",
                "--ops", ",".join(cfg.ops),
                "--targets", ",".join(cfg.targets),
                "--strategy", cfg.strategy,
                "--limit", str(cfg.limit), "--seed", str(cfg.seed),
                "--workers", str(cfg.worker_procs),
                "--retries", str(cfg.worker_retries)]
        if self.transport is not None:
            argv += ["--transport", self.transport.describe()]
        return argv

    def _default_worker(self, shard_id: int, attempt: int):
        if self.cfg.inject_crash_shard == shard_id and attempt == 1:
            # fault injection: die without publishing the shard store —
            # indistinguishable from a mid-shard worker crash
            if self._thread_mode():
                def _crash(cancelled):
                    raise RuntimeError("injected worker crash")
                return ThreadWorker(_crash)
            return SubprocessWorker(
                [sys.executable, "-c", "raise SystemExit(42)"],
                env=self._worker_env())
        if self._thread_mode():
            cfg = self.cfg

            def _run(cancelled):
                run = fleet.run_shard(
                    self.jobs, cfg.num_shards, shard_id, cfg.db,
                    transport=self.transport, workers=cfg.worker_procs,
                    retries=cfg.worker_retries)
                return run.ok
            return ThreadWorker(_run)
        return SubprocessWorker(self._worker_argv(shard_id),
                                env=self._worker_env())

    def _pending(self) -> List[int]:
        return [i for i in range(self.cfg.num_shards)
                if i not in self.done and i not in self.leases
                and i not in self.given_up]

    def _dispatch(self, shard_id: int) -> None:
        self.attempts[shard_id] += 1
        attempt = self.attempts[shard_id]
        njobs = self._shard_jobs[shard_id]
        if attempt > 1:  # healing a crashed/expired shard
            self.metrics.inc("shards_healed_total")
            self.metrics.inc("jobs_healed_total", njobs)
            self._event("healed", shard_id, f"re-dispatch attempt {attempt}")
        worker = self._worker_factory(shard_id, attempt)
        self.leases[shard_id] = ShardLease(
            shard_id=shard_id, jobs=njobs, granted_at=time.monotonic(),
            lease_s=self.cfg.lease_s, attempt=attempt, worker=worker)
        self.metrics.inc("jobs_dispatched_total", njobs)
        self._event("dispatched", shard_id, f"attempt {attempt}")
        self._log(f"shard {shard_id}: dispatched {njobs} jobs to "
                  f"{worker.describe()} (attempt {attempt}, lease "
                  f"{self.cfg.lease_s:.0f}s)")

    def _lease_failed(self, shard_id: int, reason: str) -> None:
        lease = self.leases.pop(shard_id)
        self.metrics.inc("jobs_failed_total", lease.jobs)
        self._event("failed", shard_id, reason)
        if self.attempts[shard_id] >= self.cfg.max_attempts:
            self.given_up.add(shard_id)
            self._log(f"shard {shard_id}: GIVING UP after "
                      f"{self.attempts[shard_id]} attempts ({reason})")
        else:
            self._log(f"shard {shard_id}: {reason}; will re-dispatch")

    # -- the control loop -------------------------------------------------

    def step(self) -> None:
        """One controller round: heartbeat the leases, reap finished and
        failed workers, dispatch pending shards, reconcile + snapshot once
        the fleet is quiescent."""
        self.rounds += 1
        self.metrics.inc("rounds_total")
        now = time.monotonic()
        for sid in sorted(self.leases):
            lease = self.leases[sid]
            code = lease.worker.poll()
            if code is None:
                if lease.expired(now):
                    self.metrics.inc("lease_expiries_total")
                    lease.worker.kill()
                    self._lease_failed(
                        sid, f"lease expired after {lease.lease_s:.1f}s "
                             f"(worker killed)")
                else:
                    lease.heartbeat(now)
                continue
            if code == 0 and fleet.shard_present(self.cfg.db, sid,
                                                 transport=self.transport):
                del self.leases[sid]
                self.done.add(sid)
                self._dirty = True
                self.metrics.inc("jobs_done_total", lease.jobs)
                self._event("done", sid, f"attempt {lease.attempt}")
                self._log(f"shard {sid}: done ({lease.jobs} jobs, attempt "
                          f"{lease.attempt})")
            elif code == 0:
                self._lease_failed(sid, "worker exited 0 without "
                                        "publishing its store")
            else:
                self._lease_failed(sid, f"worker crashed (exit {code})")
        for sid in self._pending():
            if len(self.leases) >= self.cfg.max_workers:
                break
            self._dispatch(sid)
        if not self.leases and not self._pending() and self._dirty:
            self.reconcile()
        self.metrics.set("active_leases", len(self.leases))
        self.metrics.set("shards_done", len(self.done))
        self.metrics.set("shards_failed", len(self.given_up))

    def reconcile(self) -> fleet.SyncReport:
        """``sync`` the shard stores into the base store, then re-verify
        the merge the way ``sync --verify`` does: a fresh in-memory merge
        of the same sources must produce the same best-record set (the
        total record order makes this deterministic — any divergence is a
        real bug or torn data, surfaced as a gauge and in the log)."""
        rep = fleet.sync(self.cfg.db, self.cfg.num_shards,
                         transport=self.transport)
        self.metrics.inc("sync_runs_total")
        scratch = ScheduleDatabase(None)
        for src in rep.absorbed:
            scratch.merge(src, provenance=True)
        div = fleet.divergence(rep.db, scratch, "store", "fresh-merge")
        for msg in div[:10]:
            self._log(f"SYNC DIVERGENCE: {msg}")
        self.metrics.set("sync_divergence", len(div))
        self.metrics.set("sync_corrupt_lines", rep.corrupt_lines)
        self.metrics.set("store_records", rep.keys)
        self._store_records = rep.keys
        self._last_tuned_at = rep.db.last_tuned_at()
        self._last_sync = rep
        self._last_sync_clean = (not div and not rep.corrupt_lines
                                 and not rep.skipped)
        self._dirty = False
        self._log(f"synced {rep.keys} keys from "
                  f"{self.cfg.num_shards - len(rep.skipped)}/"
                  f"{self.cfg.num_shards} shards "
                  f"(divergence={len(div)}, corrupt={rep.corrupt_lines})")
        self.ensure_snapshot()
        return rep

    def ensure_snapshot(self) -> None:
        """Bring the snapshot directory (and the publish channel, when
        configured) up to date with the store. Content-addressing inside
        ``SnapshotManager.ensure`` makes this exact: a new artifact is
        written/pushed iff the record payload or ``COST_MODEL_VERSION``
        changed."""
        info = self.manager.ensure()
        self._snapshot_info = info
        if info.rebuilt:
            self.metrics.inc("snapshot_rebuilds_total")
            self._log(f"snapshot rebuilt: {info.name} ({info.count} records)")
        if self.cfg.publish is not None and \
                info.sha1 != self._published_sha:
            self.manager.publish(self.cfg.publish, info=info)
            self._published_sha = info.sha1
            self.metrics.inc("snapshot_publishes_total")
            self._log(f"snapshot published: {info.name}")
        if self._cache is None or self._cache.sha1 != info.sha1:
            self._cache = ScheduleCache.load(info.path)
        self.ensure_learned()

    def ensure_learned(self) -> None:
        """Bring the learned-ranker artifact up to date with the store —
        the same ensure-on-change contract as snapshots: the ``latest``
        pointer records the sha1 of the training rows the model was fitted
        from, so ``LearnedManager.ensure`` retrains exactly when the
        store's training content (or the cost-model version) changed. A
        store too small to train on is not an error — it just isn't time
        yet."""
        if self.learned_manager is None:
            return
        try:
            info = self.learned_manager.ensure()
        except ValueError as e:
            self._log(f"learned ranker not trainable yet: {e}")
            return
        self._learned_info = info
        if info.retrained:
            self.metrics.inc("learned_retrains_total")
            self._log(f"learned ranker retrained: {info.name} "
                      f"({info.samples} samples)")
        if self.cfg.publish is not None and \
                info.sha1 != self._published_learned_sha:
            self.learned_manager.publish(self.cfg.publish, info=info)
            self._published_learned_sha = info.sha1
            self.metrics.inc("learned_publishes_total")
            self._log(f"learned ranker published: {info.name}")

    @property
    def converged(self) -> bool:
        """Every shard tuned and published, the merged store verified
        clean, and the snapshot current — the acceptance state."""
        return (len(self.done) == self.cfg.num_shards
                and not self.leases and not self.given_up
                and not self._dirty and self._last_sync_clean
                and self._snapshot_info is not None)

    @property
    def wedged(self) -> bool:
        """Nothing left to dispatch but shards were given up — the fleet
        cannot converge without operator help."""
        return bool(self.given_up) and not self.leases \
            and not self._pending()

    def stop(self) -> None:
        self._stop.set()

    def run(self, max_rounds: Optional[int] = None,
            exit_when_converged: bool = False) -> int:
        """The daemon loop. Returns 0 when converged (or stopped cleanly
        with no given-up shards), 1 otherwise. With
        ``exit_when_converged`` the loop ends at the first converged (or
        wedged) round; otherwise it keeps watching — a store change (new
        records synced in by hand, a re-pushed shard) re-triggers
        reconcile + republish."""
        while not self._stop.is_set():
            self.step()
            if exit_when_converged and (self.converged or self.wedged):
                break
            if max_rounds is not None and self.rounds >= max_rounds:
                break
            self._stop.wait(self.cfg.poll_s)
        return 0 if not self.given_up else 1

    # -- introspection (the HTTP surface) ---------------------------------

    def health(self) -> Dict:
        info = self._snapshot_info
        return {
            "status": "degraded" if self.given_up else "ok",
            "converged": self.converged,
            "rounds": self.rounds,
            "shards": {
                "total": self.cfg.num_shards,
                "done": len(self.done),
                "leased": sorted(self.leases),
                "failed": sorted(self.given_up),
            },
            "store_records": self._store_records,
            "snapshot": None if info is None else {
                "name": info.name, "sha1": info.sha1,
                "count": info.count, "built_at": info.built_at,
            },
        }

    def metrics_text(self) -> str:
        now = time.time()
        lag = -1.0 if self._last_tuned_at is None \
            else max(0.0, now - self._last_tuned_at)
        self.metrics.set("store_lag_seconds", round(lag, 3))
        built = getattr(self._snapshot_info, "built_at", None)
        age = -1.0 if built is None else max(0.0, now - built)
        self.metrics.set("snapshot_age_seconds", round(age, 3))
        info = None
        if self._snapshot_info is not None:
            info = {"sha1": self._snapshot_info.sha1,
                    "cost_model_version": COST_MODEL_VERSION}
        return self.metrics.render(info=info)

    def schedule_lookup(self, op: Optional[str] = None,
                        target: Optional[str] = None,
                        version: Optional[str] = None) -> List[Dict]:
        """Best-record lookup from the live snapshot, serialized with the
        same ``record_to_dict`` as ``query --json`` — the CLI and the HTTP
        API can never disagree. Raises ``LookupError`` before the first
        snapshot exists."""
        if self._cache is None:
            raise LookupError("no snapshot published yet")
        recs = self._cache.query(op=op, target=target, version=version)
        return [record_to_dict(r) for r in recs]


# -- HTTP API --------------------------------------------------------------

class _ControllerServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    controller: FleetController = None


class _Handler(BaseHTTPRequestHandler):
    server_version = "tuna-controller/1"

    def log_message(self, *args):  # the controller does its own logging
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, obj: Dict) -> None:
        self._send(code, json.dumps(obj, sort_keys=True, default=float)
                   + "\n", "application/json")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler protocol
        ctl: FleetController = self.server.controller
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._json(200, ctl.health())
        elif url.path == "/metrics":
            self._send(200, ctl.metrics_text(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/schedule":
            q = parse_qs(url.query)

            def _arg(name):
                vals = q.get(name)
                return vals[0] if vals else None

            try:
                records = ctl.schedule_lookup(op=_arg("op"),
                                              target=_arg("target"),
                                              version=_arg("version"))
            except LookupError as e:
                self._json(503, {"error": str(e)})
                return
            if not records:
                self._json(404, {"error": "no matching records"})
                return
            cache = ctl._cache
            self._json(200, {
                "count": len(records),
                "snapshot_sha1": cache.sha1,
                "built_at": cache.built_at,
                "cost_model_version": cache.cost_model_version,
                "records": records,
            })
        else:
            self._json(404, {"error": f"no route {url.path!r}; have "
                                      f"/schedule /healthz /metrics"})


def start_http(controller: FleetController, host: str = "127.0.0.1",
               port: int = 0) -> _ControllerServer:
    """Serve the controller's API on a daemon thread; returns the server
    (``server.server_address`` has the bound port; call ``shutdown()`` +
    ``server_close()`` to stop)."""
    server = _ControllerServer((host, port), _Handler)
    server.controller = controller
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="tuna-controller-http")
    thread.start()
    return server

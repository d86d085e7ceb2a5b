"""Distributed tuning fleet — shard the job matrix, tune, reconcile.

The port's own copy of ``repro.tuna.fleet``.

Tuna results are pure functions of (op signature, target, cost-model
version): there is no device in the tuning loop, so the MITuna-style fleet
split collapses to *pure bookkeeping*. ``shard_jobs`` deterministically
partitions the (operator × target × strategy) job matrix by hashing each
job's canonical form — shards are disjoint, covering, and stable across
runs and hosts, so re-running a shard is idempotent and any host can own
any shard id. Each shard tunes through the ordinary orchestrator into its
own store (``<base>.shardNN.jsonl``); ``sync`` reconciles shard stores into
the base store whenever they become reachable, resolving conflicts by the
total record order (cost-model version is part of the key, then best
score) and stamping per-shard provenance into ``meta``. A crashed shard
simply stays missing until its host re-runs it — sync skips absent stores
and reports them.

Shard stores reach the sync host either over a shared filesystem (the
default: ``sync`` globs ``<base>.shardNN.jsonl`` next to the base store)
or over a ``repro_torch.tuna.transport`` channel: ``run_shard(...,
transport=...)`` pushes the finished shard store (manifest + sha1), and
``sync(..., transport=...)`` pulls every shard the channel has into a
staging directory with integrity verification before merging — no shared
base directory between shard writers and the sync host.

Workflow (also exposed by ``python -m repro_torch.tuna``):

    jobs = orchestrator.jobs_for(ops, targets)     # the shared matrix
    # on host i of N (no shared fs needed with a transport):
    fleet.run_shard(jobs, N, i, base, transport=t) # tune + push
    # on any host that can reach the channel:
    fleet.sync(base, N, transport=t)               # pull + merge
    SnapshotManager(base, out_dir).publish(t)      # versioned snapshot
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.tuna import orchestrator
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord, strip_bookkeeping
from repro_torch.tuna.orchestrator import TuneJob

PROVENANCE_KEY = "provenance"


# -- deterministic sharding ----------------------------------------------

def job_fingerprint(job: TuneJob) -> str:
    """Stable content hash of a job (all fields, canonical JSON) — the
    same job hashes identically on every host and every run."""
    blob = json.dumps(dataclasses.asdict(job), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()


def shard_of(job: TuneJob, num_shards: int) -> int:
    return int(job_fingerprint(job), 16) % num_shards


def shard_jobs(jobs: Sequence[TuneJob], num_shards: int,
               shard_id: int) -> List[TuneJob]:
    """The subset of ``jobs`` owned by ``shard_id``. Partitions are
    disjoint and covering by construction (every job hashes to exactly one
    shard) and independent of the order jobs are listed in."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard_id < num_shards:
        raise ValueError(
            f"shard_id must be in [0, {num_shards}), got {shard_id}")
    return [j for j in jobs if shard_of(j, num_shards) == shard_id]


def shard_store_path(base_path: str, shard_id: int) -> str:
    """Per-shard store path derived from the base store path:
    ``db.jsonl`` -> ``db.shard03.jsonl`` (derivation is shared by tune and
    sync, so hosts never have to agree on anything but base + shard id)."""
    root, ext = os.path.splitext(os.fspath(base_path))
    return f"{root}.shard{shard_id:02d}{ext or '.jsonl'}"


# -- running shards -------------------------------------------------------

@dataclasses.dataclass
class ShardRun:
    shard_id: int
    store_path: str
    jobs: int
    report: orchestrator.RunReport
    pushed: Optional[object] = None  # transport Manifest when shipped

    @property
    def ok(self) -> bool:
        return self.report.ok


@dataclasses.dataclass
class FleetReport:
    shards: List[ShardRun]

    @property
    def ok(self) -> bool:
        return all(s.ok for s in self.shards)

    @property
    def records(self) -> List[ScheduleRecord]:
        return [r for s in self.shards for r in s.report.records]


def touch_store(path: str) -> str:
    """Create an empty store file if absent. A shard whose slice of the
    matrix happens to be empty must still leave a store behind — sync
    distinguishes 'shard finished with nothing to do' (empty file) from
    'shard crashed / hasn't run' (no file)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    open(path, "a", encoding="utf-8").close()
    return path


def shard_object_name(base_path: str, shard_id: int) -> str:
    """Host-independent transport object name for a shard store: the
    basename of the shard store path, so pushing and pulling hosts only
    have to agree on the base store *name*, never on directory layout."""
    return os.path.basename(shard_store_path(base_path, shard_id))


def shard_present(base_path: str, shard_id: int, transport=None) -> bool:
    """The crash-skip probe shared by ``sync`` and the fleet controller:
    a shard's work is *present* when its store file exists (shared-fs
    fleet) or its store object + manifest are in the channel (transport
    fleet — the manifest is the commit marker, so a mid-push crash still
    counts as absent). A shard that is not present has crashed or hasn't
    run; the controller re-dispatches it, ``sync`` skips it."""
    if transport is not None:
        from repro_torch.tuna.transport import resolve_transport

        return resolve_transport(transport).exists(
            shard_object_name(base_path, shard_id))
    return os.path.exists(shard_store_path(base_path, shard_id))


def missing_shards(base_path: str, num_shards: int,
                   transport=None) -> List[int]:
    """Shard ids whose stores have not arrived yet (crashed / not run) —
    ``shard_present`` over the whole fleet."""
    return [i for i in range(num_shards)
            if not shard_present(base_path, i, transport=transport)]


# -- leases ----------------------------------------------------------------

@dataclasses.dataclass
class ShardLease:
    """A dispatched shard's liveness contract with the controller.

    The worker holds the lease from ``granted_at`` until ``deadline``;
    liveness checks (``heartbeat``) renew ``last_heartbeat`` but never the
    deadline — a worker that outlives its lease is presumed wedged and its
    shard is re-dispatched. Because tuning is a pure function of
    (job matrix, shard id), a zombie worker that later finishes anyway is
    harmless: it pushes byte-equivalent records and the merge's total
    order makes absorbing them a no-op."""

    shard_id: int
    jobs: int                 # matrix jobs covered by this dispatch
    granted_at: float         # time.monotonic()
    lease_s: float
    attempt: int = 1          # 1 = first dispatch, >1 = heal re-dispatch
    worker: object = None     # controller-owned handle (poll()/kill())
    last_heartbeat: float = 0.0

    def __post_init__(self):
        if not self.last_heartbeat:
            self.last_heartbeat = self.granted_at

    @property
    def deadline(self) -> float:
        return self.granted_at + self.lease_s

    def heartbeat(self, now: Optional[float] = None) -> None:
        self.last_heartbeat = time.monotonic() if now is None else now

    def expired(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return now > self.deadline


def run_shard(jobs: Sequence[TuneJob], num_shards: int, shard_id: int,
              base_path: str, transport=None, **run_kwargs) -> ShardRun:
    """Tune this shard's slice of the matrix into its own store (the
    existing orchestrator does the work; extra kwargs pass through). With
    a ``transport`` (spec or instance), the finished store is pushed —
    manifest, sha1, record count — so the sync host needs no filesystem
    view of this host at all."""
    mine = shard_jobs(jobs, num_shards, shard_id)
    store = ScheduleDatabase(touch_store(shard_store_path(base_path,
                                                          shard_id)))
    report = orchestrator.run(mine, db=store, **run_kwargs)
    pushed = None
    if transport is not None:
        from repro_torch.tuna.transport import resolve_transport

        pushed = resolve_transport(transport).push(
            store.path, shard_object_name(base_path, shard_id))
    return ShardRun(shard_id, store.path, len(mine), report, pushed)


def run_fleet(jobs: Sequence[TuneJob], num_shards: int, base_path: str,
              shard_ids: Optional[Iterable[int]] = None, transport=None,
              **run_kwargs) -> FleetReport:
    """Run shards in one process (tests, single-host fleets); on a real
    fleet each host calls ``run_shard`` for the ids it owns."""
    ids = range(num_shards) if shard_ids is None else shard_ids
    return FleetReport([
        run_shard(jobs, num_shards, sid, base_path, transport=transport,
                  **run_kwargs)
        for sid in ids
    ])


# -- reconciliation -------------------------------------------------------

@dataclasses.dataclass
class SyncReport:
    base_path: str
    absorbed: Dict[str, int]          # shard store path -> records absorbed
    skipped: List[str]                # shard stores not found (crashed/late)
    keys: int                         # merged store size
    db: ScheduleDatabase = dataclasses.field(repr=False, default=None)
    corrupt: Dict[str, int] = dataclasses.field(default_factory=dict)
    pulled: List[str] = dataclasses.field(default_factory=list)

    @property
    def corrupt_lines(self) -> int:
        """Total source lines dropped as corrupt during the merge. Non-zero
        means the sync was lossy: records existed that no store absorbed —
        re-run sync after the writers finish, and treat it as a hard
        failure under ``sync --verify``."""
        return sum(self.corrupt.values())


def sync(base_path: str, num_shards: int, provenance: bool = True,
         compact: bool = True, missing_ok: bool = True,
         transport=None, staging_dir: Optional[str] = None) -> SyncReport:
    """Merge every present shard store into the base store. Missing shard
    stores (a crashed or not-yet-finished host) are skipped and reported —
    re-running ``sync`` after the shard resumes completes the merge, and
    re-syncing an already-merged shard is a no-op (the total record order
    makes absorption idempotent).

    With a ``transport`` (spec or instance), shard stores are *pulled*
    from the channel into ``staging_dir`` (default ``<base>.staging/``)
    with manifest/sha1 verification instead of being read off a shared
    filesystem; shards not yet pushed are skipped exactly like missing
    files. Sources are read under their cross-process flock either way,
    and per-source corrupt-line counts are reported (see
    ``SyncReport.corrupt_lines``)."""
    base_path = os.fspath(base_path)
    pulled: List[str] = []
    if transport is not None:
        from repro_torch.tuna.transport import resolve_transport

        from repro_torch.tuna.transport import IntegrityError, TransportError

        t = resolve_transport(transport)
        staging = os.fspath(staging_dir) if staging_dir else \
            base_path + ".staging"
        present, skipped = [], []
        for i in range(num_shards):
            name = shard_object_name(base_path, i)
            if not shard_present(base_path, i, transport=t):
                skipped.append(name)
                continue
            local = os.path.join(staging, name)
            try:
                t.pull(name, local)
            except IntegrityError:
                raise  # genuinely corrupt blob: never merge, never skip
            except TransportError:
                # raced a re-push between exists() and pull() (manifest
                # retracted mid-window): the shard is "not pushed yet"
                skipped.append(name)
                continue
            present.append(local)
            pulled.append(name)
    else:
        present, skipped = [], []
        for i in range(num_shards):
            p = shard_store_path(base_path, i)
            (present if shard_present(base_path, i) else skipped).append(p)
    if skipped and not missing_ok:
        raise FileNotFoundError(f"missing shard stores: {skipped}")
    db, stats, corrupt = ScheduleDatabase.sync(
        base_path, present, provenance=provenance, compact=compact)
    return SyncReport(base_path, stats, skipped, len(db), db,
                      corrupt=corrupt, pulled=pulled)


def divergence(a, b, label_a: str = "a", label_b: str = "b") -> List[str]:
    """Human-readable differences between two stores' best-record sets
    (``ScheduleDatabase`` or ``ScheduleCache``), ignoring merge provenance.
    Empty list == equivalent; used by ``sync --verify`` to fail CI on any
    fleet-vs-single-process divergence."""
    recs_a = {r.key: r for r in a.records()}
    recs_b = {r.key: r for r in b.records()}
    msgs = []

    def _meta(rec: ScheduleRecord) -> Dict:
        # bookkeeping (provenance, tuned_at) never counts as divergence:
        # two hosts tuning the same matrix at different times ARE converged
        return strip_bookkeeping(rec.meta)

    for key in sorted(set(recs_a) | set(recs_b)):
        ra, rb = recs_a.get(key), recs_b.get(key)
        if ra is None:
            msgs.append(f"{key}: only in {label_b}")
        elif rb is None:
            msgs.append(f"{key}: only in {label_a}")
        else:
            for field, va, vb in (
                ("config", ra.config, rb.config),
                ("score", ra.score, rb.score),
                ("evaluations", ra.evaluations, rb.evaluations),
                ("meta", _meta(ra), _meta(rb)),
            ):
                if va != vb:
                    msgs.append(f"{key}: {field} differs "
                                f"({label_a}={va!r}, {label_b}={vb!r})")
    return msgs

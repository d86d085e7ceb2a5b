"""Persistent schedule database — the MITuna-style service substrate.

The port's own copy of ``repro.tuna.db``: the same record schema and file
format, so a store written by either package loads in the other (records
are keyed by target, so the port's ``gpu_h100`` records and the reference's
TPU and CPU records sit side by side in one file).

Tuna schedules are derived *statically*, so a result is a pure function of
``(operator signature, target, cost-model version)`` and can be persisted and
shared across processes/hosts instead of recomputed per process (the same
observation behind AutoTVM tuning logs and TLP's record datasets).

Storage is an **append-only JSONL** file, schema ``cm1`` — one record per
line, formalising the ad-hoc ``experiments/schedule_db.jsonl`` format:

    {
      "op":          "matmul[K=256,M=256,N=256,dtype_bytes=2]",
      "target":      "gpu_h100",
      "version":     "cm1",                 # cost-model version (see
                                            # repro_torch.core.cost_model)
      "config":      {"bm": 256, ...},      # winning schedule knobs
      "score":       2.82e-06,              # predicted cost (lower = faster)
      "evaluations": 48,                    # cost-model calls spent finding it
      "meta":        {"strategy": "exhaustive", "default_score": ...}
    }

Appends are single ``write`` calls on an ``O_APPEND`` handle (atomic on
POSIX); compaction rewrites via temp-file + ``os.replace`` so readers never
observe a half-written store. The in-memory index keeps the *best* (lowest
score) record per key; the log keeps full history until ``compact()``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

try:  # POSIX cross-process lock; degrades to thread-only elsewhere
    import fcntl

    def _flock(f) -> None:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
except ImportError:  # pragma: no cover
    def _flock(f) -> None:
        pass

from repro_torch.core.cost_model import COST_MODEL_VERSION

SCHEMA = "cm1"

Key = Tuple[str, str, str]  # (op signature, target name, cost-model version)

# Meta keys that are *bookkeeping*, not tuning content: which shard a record
# travelled through (``provenance``) and when it was tuned (``tuned_at``).
# They are stripped from the canonical record form (tie-breaks, divergence
# checks): two hosts tuning the same key at different wall-clock times must
# still converge on byte-identical winners, or fleet merges stop being
# order-independent and ``sync --verify`` flags phantom divergence.
TUNED_AT_KEY = "tuned_at"
BOOKKEEPING_META = frozenset({"provenance", TUNED_AT_KEY})


def strip_bookkeeping(meta: Dict) -> Dict:
    """``meta`` without the bookkeeping keys (see ``BOOKKEEPING_META``)."""
    return {k: v for k, v in meta.items() if k not in BOOKKEEPING_META}


def stamp_tuned_at(meta: Optional[Dict] = None,
                   now: Optional[float] = None) -> Dict:
    """Return ``meta`` with a wall-clock ``tuned_at`` stamp (seconds since
    the epoch, ms precision) added when absent. The stamp is what the fleet
    controller's ``store_lag_seconds`` gauge is computed from; records
    without it (pre-stamp stores) still load and merge — they just don't
    move the lag gauge."""
    meta = dict(meta or {})
    if TUNED_AT_KEY not in meta:
        meta[TUNED_AT_KEY] = round(time.time() if now is None else now, 3)
    return meta


@dataclasses.dataclass(frozen=True)
class ScheduleRecord:
    op: str
    target: str
    config: Dict
    score: float
    evaluations: int = 0
    meta: Dict = dataclasses.field(default_factory=dict)
    version: str = COST_MODEL_VERSION

    @property
    def key(self) -> Key:
        return (self.op, self.target, self.version)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True,
                          default=float)

    @classmethod
    def from_json(cls, line: str) -> "ScheduleRecord":
        return cls.from_dict(json.loads(line))

    @classmethod
    def from_dict(cls, obj: Dict) -> "ScheduleRecord":
        return cls(
            op=str(obj["op"]),
            target=str(obj["target"]),
            config=dict(obj["config"]),
            score=float(obj["score"]),
            evaluations=int(obj.get("evaluations", 0)),
            meta=dict(obj.get("meta", {})),
            version=str(obj.get("version", COST_MODEL_VERSION)),
        )


def query_index(index: Dict[Key, ScheduleRecord], op: Optional[str] = None,
                target: Optional[str] = None,
                version: Optional[str] = None) -> List[ScheduleRecord]:
    """Filter a best-record index (shared by ``ScheduleDatabase.query`` and
    ``ScheduleCache.query`` so the two stores can never diverge): ``op``
    matches exactly or as a prefix (``matmul`` matches every matmul
    shape), ``target``/``version`` match exactly."""
    out = []
    for key in sorted(index):
        rec = index[key]
        if op is not None and not (rec.op == op or rec.op.startswith(op)):
            continue
        if target is not None and rec.target != target:
            continue
        if version is not None and rec.version != version:
            continue
        out.append(rec)
    return out


def record_to_dict(rec: ScheduleRecord) -> Dict:
    """The one record serialization shared by ``query --json``, ``export``,
    and the fleet controller's ``/schedule`` endpoint — operators reading
    the CLI and services reading the HTTP API can never disagree on field
    names or types."""
    obj = dataclasses.asdict(rec)
    obj["score"] = float(rec.score)
    return obj


def _canonical(rec: ScheduleRecord) -> str:
    """Canonical record JSON with merge bookkeeping stripped: the
    provenance stamp says which shard a record travelled through and
    ``tuned_at`` when, neither of which must ever decide who wins a tie
    (a fleet-merged store and a single-process store would otherwise pick
    different winners)."""
    obj = dataclasses.asdict(rec)
    obj["meta"] = strip_bookkeeping(obj["meta"])
    return json.dumps(obj, sort_keys=True, default=float)


def record_beats(rec: ScheduleRecord, cur: ScheduleRecord) -> bool:
    """Preference order between same-key records: lower score wins; exact
    score ties break on the canonical (provenance-stripped) record JSON,
    and a canonical tie keeps the incumbent. A total order over canonical
    records is what makes merges commutative, associative, and idempotent
    — the winner for a key is independent of arrival order, so fleet
    shards can sync in any order and every host converges on the same
    store."""
    if rec.score != cur.score:
        return rec.score < cur.score
    return _canonical(rec) < _canonical(cur)


class ScheduleDatabase:
    """JSONL-backed schedule store with an in-memory best-record index.

    ``path=None`` gives a purely in-memory database (tests, dry runs). A
    path that does not exist yet is created on first ``add``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = os.fspath(path) if path is not None else None
        self._lock = threading.Lock()
        self._best: Dict[Key, ScheduleRecord] = {}
        self.lines_read = 0
        self.corrupt_lines = 0
        if self.path and os.path.exists(self.path):
            for rec in self._iter_file(self.path):
                self._absorb(rec)

    # -- loading ---------------------------------------------------------

    def _iter_file(self, path: str, lock: bool = False,
                   ) -> Iterator[ScheduleRecord]:
        """Parse a store file. ``lock=True`` takes the cross-process flock
        before reading: appends are single writes flushed under that lock,
        so a locked read can never observe the torn tail of an in-flight
        writer — without it a half-written final line silently counts as
        corrupt and the record is dropped."""
        with open(path, "r", encoding="utf-8") as f:
            if lock:
                _flock(f)
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = ScheduleRecord.from_json(line)
                except (ValueError, KeyError, TypeError):
                    self.corrupt_lines += 1
                    continue
                self.lines_read += 1
                yield rec

    def _absorb(self, rec: ScheduleRecord) -> bool:
        """Index ``rec``; True iff it is a new key or beats the incumbent."""
        cur = self._best.get(rec.key)
        if cur is None or record_beats(rec, cur):
            self._best[rec.key] = rec
            return True
        return False

    # -- writes ----------------------------------------------------------

    def add(self, rec: ScheduleRecord, persist: bool = True) -> bool:
        """Append ``rec`` to the log and index it. Returns True iff the
        record became the best for its key."""
        with self._lock:
            improved = self._absorb(rec)
            if persist and self.path:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._append_locked(rec.to_json() + "\n")
        return improved

    def _append_locked(self, line: str, max_retries: int = 50) -> None:
        """Append under the cross-process lock; if a concurrent ``compact``
        replaced the log while we waited (our fd then points at the orphaned
        inode), reopen against the new file and retry. Retries are bounded:
        a store path that *keeps* vanishing (the store directory deleted
        mid-fleet, a job scrubbing the workdir) is an operational failure
        that must surface, not an infinite busy-loop."""
        for _ in range(max_retries):
            with open(self.path, "a", encoding="utf-8") as f:
                _flock(f)
                try:
                    cur_ino = os.stat(self.path).st_ino
                except FileNotFoundError:
                    continue
                if os.fstat(f.fileno()).st_ino != cur_ino:
                    continue
                f.write(line)
                return
        raise RuntimeError(
            f"{self.path}: gave up appending after {max_retries} attempts — "
            f"the store file keeps vanishing or being replaced out from "
            f"under the writer (was the store directory removed while the "
            f"fleet is running?)")

    def merge(self, other_path: str, provenance=None,
              lock_source: bool = True) -> int:
        """Absorb another store's records; persists only the improving ones
        (the log stays append-only, compaction prunes). Conflicts resolve by
        the total record order (cost-model version is part of the key; lower
        score wins, ties break canonically). ``provenance=True`` stamps
        absorbed records with ``meta["provenance"] = <source basename>`` (a
        string label is used verbatim) so a merged store says which shard
        each winner came from. Returns how many records improved/extended
        this store.

        The source is snapshotted under its cross-process flock (then the
        lock is released before any write, so two hosts merging toward each
        other cannot deadlock): a shard writer mid-append either finishes
        its line before we read or hasn't started it — its record is merged
        or deferred to the next sync, never torn and miscounted as corrupt.
        Corrupt lines that *do* remain accumulate on ``corrupt_lines``;
        ``sync`` reports the per-source delta."""
        if provenance is True:
            provenance = os.path.basename(os.fspath(other_path))
        absorbed = 0
        for rec in list(self._iter_file(other_path, lock=lock_source)):
            if provenance:
                rec = dataclasses.replace(
                    rec, meta={**rec.meta, "provenance": provenance})
            if self._would_improve(rec):
                self.add(rec, persist=True)
                absorbed += 1
        return absorbed

    def merge_all(self, paths: Sequence[str], provenance=True,
                  ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Merge several shard stores; returns ``(absorbed counts,
        corrupt-line counts)`` per path — a non-zero corrupt count means
        lines were dropped and the merge is *not* lossless."""
        stats: Dict[str, int] = {}
        corrupt: Dict[str, int] = {}
        for p in paths:
            before = self.corrupt_lines
            stats[os.fspath(p)] = self.merge(p, provenance=provenance)
            corrupt[os.fspath(p)] = self.corrupt_lines - before
        return stats, corrupt

    @classmethod
    def sync(cls, dst_path: str, shard_paths: Sequence[str],
             provenance=True, compact: bool = True,
             ) -> Tuple["ScheduleDatabase", Dict[str, int], Dict[str, int]]:
        """Reconcile per-shard stores into ``dst_path`` (the fleet read side
        of ``repro_torch.tuna.fleet``): open the base store, absorb every shard,
        optionally compact. Returns ``(merged db, absorbed counts,
        corrupt-line counts per source)``."""
        db = cls(dst_path)
        stats, corrupt = db.merge_all(shard_paths, provenance=provenance)
        if compact:
            db.compact()
        return db, stats, corrupt

    def _would_improve(self, rec: ScheduleRecord) -> bool:
        cur = self._best.get(rec.key)
        return cur is None or record_beats(rec, cur)

    def compact(self) -> int:
        """Rewrite the log keeping only the best record per key (atomic
        replace). Holds the cross-process lock and re-reads the log first,
        so records appended by other processes since our load are absorbed
        rather than clobbered. Returns the number of log lines dropped
        (superseded duplicates + corrupt lines)."""
        if not self.path:
            return 0
        with self._lock:
            d = os.path.dirname(self.path) or "."
            os.makedirs(d, exist_ok=True)
            while True:
                with open(self.path, "a+", encoding="utf-8") as f:
                    _flock(f)
                    if os.fstat(f.fileno()).st_ino != os.stat(self.path).st_ino:
                        continue  # lost a race with another compact; reopen
                    f.seek(0)
                    before = 0
                    for line in f:
                        if not line.strip():
                            continue
                        before += 1
                        try:
                            self._absorb(ScheduleRecord.from_json(line))
                        except (ValueError, KeyError, TypeError):
                            pass  # corrupt line: healed by the rewrite
                    records = [self._best[k] for k in sorted(self._best)]
                    fd, tmp = tempfile.mkstemp(dir=d, suffix=".jsonl.tmp")
                    try:
                        with os.fdopen(fd, "w", encoding="utf-8") as out:
                            for rec in records:
                                out.write(rec.to_json() + "\n")
                        os.replace(tmp, self.path)
                    except BaseException:
                        if os.path.exists(tmp):
                            os.unlink(tmp)
                        raise
                    return before - len(records)

    # -- queries ---------------------------------------------------------

    def best(self, op: str, target: str,
             version: str = COST_MODEL_VERSION) -> Optional[ScheduleRecord]:
        return self._best.get((op, target, version))

    def query(self, op: Optional[str] = None, target: Optional[str] = None,
              version: Optional[str] = None) -> List[ScheduleRecord]:
        """Best records matching the filters; ``op`` matches exactly or as a
        prefix (so ``matmul`` matches every matmul shape)."""
        return query_index(self._best, op=op, target=target, version=version)

    def records(self) -> List[ScheduleRecord]:
        return [self._best[k] for k in sorted(self._best)]

    def last_tuned_at(self) -> Optional[float]:
        """Newest ``meta.tuned_at`` stamp across the best records — what
        the controller's ``store_lag_seconds`` gauge measures. ``None``
        when no record carries the stamp (pre-stamp stores)."""
        stamps = [r.meta[TUNED_AT_KEY] for r in self._best.values()
                  if isinstance(r.meta.get(TUNED_AT_KEY), (int, float))]
        return max(stamps) if stamps else None

    def export(self, out_path: str) -> int:
        """Write the best records as a JSON array (for dashboards / diffing);
        returns the record count."""
        records = [record_to_dict(r) for r in self.records()]
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(records, f, indent=2, sort_keys=True, default=float)
            f.write("\n")
        return len(records)

    def __len__(self) -> int:
        return len(self._best)

    def __contains__(self, key: Key) -> bool:
        return key in self._best

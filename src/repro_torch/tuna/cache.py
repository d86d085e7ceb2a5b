"""Serving-time schedule cache — an immutable snapshot of the store.

The port's own copy of ``repro.tuna.cache``, with one difference: the
``built_at`` stamp is written at a fixed width (seconds with exactly three
decimals, ``_stamp_json``), so a snapshot's size does not depend on the
digit count of its build time. The reference writes ``round(time.time(),
3)`` through ``json.dump``, which drops trailing zeros; files stay
interchangeable, since JSON reads both forms as the same number.

The JSONL store is optimised for *writes*: append-only log, cross-process
locks, best-record index rebuilt on every open. The serving hot path wants
the opposite trade — pure reads at request rate, no locks, no log scans —
the offline/online split of learned-cost-model serving: tune
offline into the store, then compile the best-record set into a flat
artifact and serve lookups from that. ``ScheduleCache`` is the artifact:
built by ``python -m repro_torch.tuna snapshot`` (or ``ScheduleCache.build``),
loaded once, immutable thereafter, so ``best()`` is a single dict probe
with no lock acquisition — safe to share across serving threads.

Snapshot files are one JSON object (schema ``tuna-snapshot-v1``) written
header-first: ``schema``/``cost_model_version``/``count``/``sha1`` come
before the record array, so ``read_snapshot_header`` can stat a snapshot's
identity from the first few KB without parsing the records. ``load``
verifies the sha1 digest (torn fleet copies fail loudly) and rejects
snapshots built under a different ``COST_MODEL_VERSION`` — the version is
part of every record key, so a stale snapshot would load cleanly and then
miss on every single lookup, silently sending serving back to full
searches (pass ``allow_stale=True`` to keep it, with a warning).

``SnapshotManager`` is the lifecycle above single files: content-addressed
snapshot names (``<prefix>.<cost-model-version>-<digest>.json``) plus an
atomically-updated ``latest`` pointer, rebuilt whenever the store content
or the cost-model version changes, and publishable over a
``repro_torch.tuna.transport`` channel. Long-running serve processes hot-reload
through ``core.tuner.refresh_default_cache()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
import warnings
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.tuna.db import (
    Key,
    ScheduleDatabase,
    ScheduleRecord,
    query_index,
    record_beats,
)

SNAPSHOT_SCHEMA = "tuna-snapshot-v1"
POINTER_SCHEMA = "tuna-snapshot-pointer-v1"


class StaleSnapshotError(ValueError):
    """Snapshot was built under a different ``COST_MODEL_VERSION`` than
    this process runs: loading it would silently miss on every lookup."""


class StaleSnapshotWarning(UserWarning):
    """A stale snapshot was loaded anyway (``allow_stale=True``)."""


def _stamp_json(text: str, built_at: Optional[float]) -> str:
    """``text`` (JSON with ``"built_at": null``) with the stamp written at a
    fixed width: ``%.3f`` seconds, so every stamp of this epoch has the same
    number of characters. ``null`` stays for an unstamped artifact. A
    quoted ``"built_at": null`` inside a string value would be escaped, so
    the first match is the key's."""
    if built_at is None:
        return text
    return text.replace('"built_at": null', f'"built_at": {built_at:.3f}', 1)


def _payload(records: Sequence[Dict]) -> str:
    # canonical serialization shared by save() and load(): json round-trips
    # floats via shortest-repr, so dump(load(dump(x))) == dump(x)
    return json.dumps(list(records), sort_keys=True, default=float)


def read_snapshot_header(path: Optional[str] = None, *,
                         data: Optional[str] = None,
                         prefix_chars: int = 8192) -> Dict:
    """Snapshot/pointer header without parsing the record array.

    Snapshots are written header-first (``records`` is the final key), so
    the identity fields — ``schema``, ``sha1``, ``cost_model_version``,
    ``count`` — live in the first few KB: slice the text before the
    ``"records"`` key and close the object. This is what makes snapshot
    revalidation cheap enough to run between serving waves (a full parse
    of a large snapshot is exactly the cost hot reload must avoid).
    Falls back to a full parse for pre-header-first files. Raises
    ``ValueError`` when the file is not a snapshot or pointer at all.
    """
    if data is None:
        with open(path, "r", encoding="utf-8") as f:
            data = f.read(prefix_chars + 1)
    head = data[:prefix_chars]
    cut = head.find('"records"')
    if cut != -1:
        frag = head[:cut].rstrip().rstrip(",") + "}"
        try:
            hdr = json.loads(frag)
        except ValueError:
            hdr = None
        if hdr is not None and "schema" in hdr and "sha1" in hdr:
            return hdr
    # fallback: pointer files (no records key), legacy sorted-key
    # snapshots, or headers larger than the probe window
    if path is not None and len(data) > prefix_chars:
        with open(path, "r", encoding="utf-8") as f:
            data = f.read()
    obj = json.loads(data)
    if not isinstance(obj, dict) or "schema" not in obj:
        raise ValueError("not a schedule snapshot or pointer")
    obj.pop("records", None)
    return obj


class ScheduleCache:
    """Immutable best-record index with O(1) lock-free lookups."""

    immutable = True  # write paths (tuner write-backs) check this flag

    def __init__(self, records: Sequence[ScheduleRecord],
                 source: str = "<memory>"):
        best: Dict[Key, ScheduleRecord] = {}
        for rec in records:
            cur = best.get(rec.key)
            if cur is None or record_beats(rec, cur):
                best[rec.key] = rec
        self._best = best
        self.source = source
        self.sha1: Optional[str] = None  # payload digest; set by save/load
        self.built_at: Optional[float] = None  # wall-clock build stamp; set
        #   by save/load (None for pre-stamp snapshots) — what the
        #   controller's snapshot_age_seconds gauge is computed from
        self.cost_model_version = COST_MODEL_VERSION
        self.stale = False  # True only for allow_stale version-mismatch loads
        self.hits = 0    # serving stats: plain ints, never locked (exact
        self.misses = 0  # under the GIL, approximate under free threading)

    # -- build / persist -------------------------------------------------

    @classmethod
    def from_db(cls, db: ScheduleDatabase) -> "ScheduleCache":
        return cls(db.records(), source=db.path or "<memory>")

    @classmethod
    def build(cls, db: Union[str, os.PathLike, ScheduleDatabase],
              out_path: str) -> "ScheduleCache":
        """Compile a store (path or instance) into a snapshot file."""
        if not isinstance(db, ScheduleDatabase):
            db = ScheduleDatabase(os.fspath(db))
        cache = cls.from_db(db)
        cache.save(out_path)
        return cache

    def payload_sha1(self) -> str:
        """Content digest over the canonical record payload — the snapshot
        identity used by manifests, versioned names, and hot-reload
        revalidation. Memoised (the record set is immutable)."""
        if self.sha1 is None:
            records = [dataclasses.asdict(r) for r in self.records()]
            self.sha1 = hashlib.sha1(_payload(records).encode()).hexdigest()
        return self.sha1

    def save(self, out_path: str) -> int:
        """Write the snapshot (atomic temp-file + replace), header fields
        before the record array so ``read_snapshot_header`` stays cheap;
        returns the record count."""
        records = [dataclasses.asdict(r) for r in self.records()]
        # built_at sits in the header (before "records", so the cheap
        # header probe sees it) but outside the sha1 payload: rebuilding
        # identical content at a later time keeps the same content address
        self.built_at = round(time.time(), 3)
        obj = {
            "schema": SNAPSHOT_SCHEMA,
            "cost_model_version": COST_MODEL_VERSION,
            "count": len(records),
            "sha1": self.payload_sha1(),
            "built_at": None,  # written at a fixed width by _stamp_json
            "source": self.source,
            "records": records,
        }
        d = os.path.dirname(out_path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".snapshot.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(_stamp_json(json.dumps(obj, default=float),
                                    self.built_at))
                f.write("\n")
            os.replace(tmp, out_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return len(records)

    @classmethod
    def load(cls, path: str, allow_stale: bool = False) -> "ScheduleCache":
        """Load + verify a snapshot; follows a ``latest`` pointer file.

        Raises ``ValueError`` on schema mismatch or digest corruption and
        ``StaleSnapshotError`` when the snapshot was built under a
        different ``COST_MODEL_VERSION`` (every lookup would miss — the
        version is part of the key — so serving would silently pay full
        searches). ``allow_stale=True`` downgrades that to a
        ``StaleSnapshotWarning`` and marks the instance ``.stale``."""
        path = os.fspath(path)
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        if isinstance(obj, dict) and obj.get("schema") == POINTER_SCHEMA:
            target = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  obj["snapshot"])
            return cls.load(target, allow_stale=allow_stale)
        if not isinstance(obj, dict) or obj.get("schema") != SNAPSHOT_SCHEMA:
            schema = obj.get("schema") if isinstance(obj, dict) else None
            raise ValueError(
                f"{path}: not a schedule snapshot "
                f"(schema={schema!r}, want {SNAPSHOT_SCHEMA!r})")
        digest = hashlib.sha1(_payload(obj["records"]).encode()).hexdigest()
        if digest != obj.get("sha1"):
            raise ValueError(
                f"{path}: snapshot digest mismatch (corrupt or torn copy); "
                f"rebuild with `python -m repro_torch.tuna snapshot`")
        snap_version = obj.get("cost_model_version")
        stale = snap_version != COST_MODEL_VERSION
        if stale:
            msg = (
                f"{path}: snapshot was built for cost-model version "
                f"{snap_version!r} but this process runs "
                f"{COST_MODEL_VERSION!r}; the version is part of every "
                f"record key, so serving it would miss on every lookup. "
                f"Rebuild it: `python -m repro_torch.tuna snapshot` (to inspect "
                f"it anyway: allow_stale=True, or `python -m repro_torch.tuna "
                f"query --snapshot ... --allow-stale`)")
            if not allow_stale:
                raise StaleSnapshotError(msg)
            warnings.warn(msg, StaleSnapshotWarning, stacklevel=2)
        records = [ScheduleRecord.from_dict(r) for r in obj["records"]]
        cache = cls(records, source=obj.get("source", path))
        cache.sha1 = obj["sha1"]
        cache.built_at = obj.get("built_at")  # None: pre-stamp snapshot
        cache.cost_model_version = snap_version
        cache.stale = stale
        return cache

    # -- reads (the serving hot path) ------------------------------------

    def best(self, op: str, target: str,
             version: str = COST_MODEL_VERSION) -> Optional[ScheduleRecord]:
        rec = self._best.get((op, target, version))
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def query(self, op: Optional[str] = None, target: Optional[str] = None,
              version: Optional[str] = None) -> List[ScheduleRecord]:
        """Same filter semantics as ``ScheduleDatabase.query`` (shared
        implementation, so the stores cannot diverge)."""
        return query_index(self._best, op=op, target=target, version=version)

    def records(self) -> List[ScheduleRecord]:
        return [self._best[k] for k in sorted(self._best)]

    def add(self, *args, **kwargs):
        raise TypeError(
            "ScheduleCache is an immutable snapshot; write to the "
            "ScheduleDatabase and rebuild (`python -m repro_torch.tuna snapshot`)")

    def __len__(self) -> int:
        return len(self._best)

    def __contains__(self, key: Key) -> bool:
        return key in self._best


# -- snapshot lifecycle ----------------------------------------------------

@dataclasses.dataclass
class SnapshotInfo:
    """What ``SnapshotManager.ensure`` did: the versioned snapshot path,
    the ``latest`` pointer path, and whether anything changed."""

    name: str
    path: str
    latest: str
    sha1: str
    count: int
    rebuilt: bool     # a new versioned snapshot file was written
    repointed: bool   # the latest pointer moved
    built_at: Optional[float] = None  # wall-clock stamp of the snapshot
    #   file latest points at (survives no-op ensures: age keeps growing)


class SnapshotManager:
    """Keeps a directory of versioned snapshots consistent with a store.

    Snapshot identity is content-addressed: the versioned name embeds the
    builder's ``COST_MODEL_VERSION`` and the record-payload sha1, so a
    cost-model bump *or* any store change yields a new name — ``ensure``
    rebuilds exactly when identity changes and is a cheap no-op otherwise
    (re-publishing after every fleet sync is safe to cron). The ``latest``
    pointer (schema ``tuna-snapshot-pointer-v1``, atomic replace) is the
    stable path serving processes watch: ``ScheduleCache.load`` follows
    it, and ``core.tuner.refresh_default_cache`` revalidates through its
    sha1 field without touching the record payload.
    """

    def __init__(self, db_path: str, out_dir: str,
                 prefix: str = "schedule_cache"):
        self.db_path = os.fspath(db_path)
        self.out_dir = os.fspath(out_dir)
        self.prefix = prefix

    @property
    def latest_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.prefix}.latest.json")

    def snapshot_name(self, sha1: str) -> str:
        return f"{self.prefix}.{COST_MODEL_VERSION}-{sha1[:12]}.json"

    def current(self) -> Optional[Dict]:
        """The latest pointer's header, or None when never published."""
        try:
            return read_snapshot_header(self.latest_path)
        except (FileNotFoundError, ValueError):
            return None

    def ensure(self, force: bool = False) -> SnapshotInfo:
        """Bring the snapshot directory up to date with the store: write
        the versioned snapshot if its content-addressed name is missing
        (or ``force``), and repoint ``latest`` at it. Old versioned
        snapshots are left in place — in-flight pulls and still-running
        serve processes keep a consistent artifact until they refresh."""
        cache = ScheduleCache.from_db(ScheduleDatabase(self.db_path))
        digest = cache.payload_sha1()
        name = self.snapshot_name(digest)
        path = os.path.join(self.out_dir, name)
        rebuilt = force or not os.path.exists(path)
        if rebuilt:
            cache.save(path)
            built_at = cache.built_at
        else:  # no-op ensure: the artifact keeps its original build stamp
            try:
                built_at = read_snapshot_header(path).get("built_at")
            except (OSError, ValueError):
                built_at = None
        cur = self.current()
        repointed = cur is None or cur.get("snapshot") != name
        if repointed:
            self._write_pointer(name, digest, len(cache), built_at)
        return SnapshotInfo(name=name, path=path, latest=self.latest_path,
                            sha1=digest, count=len(cache),
                            rebuilt=rebuilt, repointed=repointed,
                            built_at=built_at)

    def _write_pointer(self, name: str, sha1: str, count: int,
                       built_at: Optional[float] = None) -> None:
        obj = {
            "schema": POINTER_SCHEMA,
            "snapshot": name,
            "sha1": sha1,
            "count": count,
            "built_at": None,  # written at a fixed width by _stamp_json
            "cost_model_version": COST_MODEL_VERSION,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, suffix=".pointer.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(_stamp_json(json.dumps(obj, sort_keys=True),
                                    built_at))
                f.write("\n")
            os.replace(tmp, self.latest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def publish(self, transport,
                info: Optional[SnapshotInfo] = None) -> List:
        """``ensure`` + push the versioned snapshot and the ``latest``
        pointer over a transport (spec or instance). Pass the
        ``SnapshotInfo`` from an ``ensure()`` you already ran to skip a
        second store load + digest pass. Pushing the payload before the
        pointer means a puller that sees the new pointer can always pull
        the snapshot it names. Returns the manifests."""
        from repro_torch.tuna.transport import resolve_transport

        t = resolve_transport(transport)
        if info is None:
            info = self.ensure()
        manifests = [t.push(info.path, info.name)]
        manifests.append(t.push(self.latest_path,
                                os.path.basename(self.latest_path)))
        return manifests

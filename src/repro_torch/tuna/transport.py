"""Fleet transport — move shard stores and snapshots between hosts.

The port's own copy of ``repro.tuna.transport``. A fleet need not share a
filesystem: real fleets ship artifacts (AutoTVM tuning logs, learned
cost-model offline/online splits): a shard host *pushes*
its store into a channel, the sync host *pulls* whatever shards have
arrived, and the serving side pulls published snapshots. ``Transport`` is
that channel, deliberately tiny — named blobs plus a **manifest** per blob
(sha1 over the payload, record count, cost-model version of the pushing
process) so every pull is integrity-verified with the same digest
discipline the snapshot format already uses: a torn or truncated copy
fails loudly at pull time, never at serve time.

Two implementations ship:

* ``LocalDirTransport`` — a directory as the bucket (shared fs, NFS mount,
  the target of an out-of-band rsync). The baseline, and what CI's
  transport-smoke job drives.
* ``MemoryTransport`` — an in-process object store (class-level buckets
  shared across instances), standing in for an HTTP/object-store channel
  in tests: shard "hosts" and the sync "host" share nothing but the
  bucket name.

``resolve_transport`` turns CLI/env specs into instances::

    dir:///var/tuna/bucket   (or a bare path)  -> LocalDirTransport
    mem://ci-bucket                            -> MemoryTransport
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Dict, List, Optional, Union

from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.tuna.db import _flock

MANIFEST_SCHEMA = "tuna-manifest-v1"
MANIFEST_SUFFIX = ".manifest"


class TransportError(RuntimeError):
    """A transport operation failed (missing object, missing manifest)."""


class IntegrityError(TransportError):
    """Pulled payload does not match its manifest digest (torn/corrupt
    copy) — re-push from the source host instead of serving it."""


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Sidecar metadata pushed with every blob; the pull side verifies
    ``sha1`` before the payload ever reaches a store or a snapshot load."""

    name: str
    sha1: str
    size: int
    records: int                # JSONL lines / snapshot record count
    cost_model_version: str
    schema: str = MANIFEST_SCHEMA

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: Union[str, bytes]) -> "Manifest":
        obj = json.loads(blob)
        if obj.get("schema") != MANIFEST_SCHEMA:
            raise TransportError(
                f"bad manifest (schema={obj.get('schema')!r}, "
                f"want {MANIFEST_SCHEMA!r})")
        return cls(name=str(obj["name"]), sha1=str(obj["sha1"]),
                   size=int(obj["size"]), records=int(obj["records"]),
                   cost_model_version=str(obj["cost_model_version"]))


def _count_records(name: str, data: bytes) -> int:
    """Best-effort record count for the manifest: JSONL stores count
    non-empty lines; snapshot/pointer JSON reads the header ``count``."""
    if name.endswith(".jsonl"):
        return sum(1 for ln in data.splitlines() if ln.strip())
    try:
        from repro_torch.tuna.cache import read_snapshot_header

        return int(read_snapshot_header(data=data.decode()).get("count", 0))
    except (ValueError, UnicodeDecodeError):
        return 0


class Transport:
    """Named-blob channel with manifest-verified pulls.

    Subclasses implement the three raw primitives (``_put``/``_get``/
    ``_names``); push/pull/exists/list and the integrity discipline live
    here so every implementation gets them identically.
    """

    # -- raw primitives (subclass responsibility) ------------------------

    def _put(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def _get(self, name: str) -> bytes:
        """Raise ``KeyError`` when the blob is absent."""
        raise NotImplementedError

    def _delete(self, name: str) -> None:
        """Remove a blob; absent is a no-op."""
        raise NotImplementedError

    def _names(self) -> List[str]:
        raise NotImplementedError

    # -- the public protocol ---------------------------------------------

    def push(self, local_path: str, name: Optional[str] = None) -> Manifest:
        """Upload ``local_path`` (read under the store flock, so an
        in-flight local writer can't hand us a torn tail) plus its
        manifest. Returns the manifest.

        Write order keeps the manifest a truthful commit marker even on a
        *re*-push (a crashed shard host re-running): retract the old
        manifest, replace the payload, commit the new manifest. A reader
        in the window sees "not pushed yet" and skips — it can never pair
        a fresh payload with a stale manifest."""
        local_path = os.fspath(local_path)
        name = name or os.path.basename(local_path)
        with open(local_path, "rb") as f:
            _flock(f)
            data = f.read()
        man = Manifest(
            name=name,
            sha1=hashlib.sha1(data).hexdigest(),
            size=len(data),
            records=_count_records(name, data),
            cost_model_version=COST_MODEL_VERSION,
        )
        self._delete(name + MANIFEST_SUFFIX)
        self._put(name, data)
        self._put(name + MANIFEST_SUFFIX, man.to_json().encode())
        return man

    def pull(self, name: str, local_path: str) -> Manifest:
        """Download ``name`` to ``local_path`` (atomic temp-file +
        replace), verifying the payload digest against the manifest."""
        try:
            data = self._get(name)
        except KeyError:
            raise TransportError(f"{self.describe()}: no object {name!r}")
        try:
            man = Manifest.from_json(self._get(name + MANIFEST_SUFFIX))
        except KeyError:
            raise TransportError(
                f"{self.describe()}: object {name!r} has no manifest — "
                f"pushed by something other than this transport?")
        digest = hashlib.sha1(data).hexdigest()
        if digest != man.sha1 or len(data) != man.size:
            raise IntegrityError(
                f"{self.describe()}: {name!r} payload does not match its "
                f"manifest (got sha1 {digest[:12]}/{len(data)}B, manifest "
                f"says {man.sha1[:12]}/{man.size}B) — torn or corrupt "
                f"copy; re-push from the source host")
        local_path = os.fspath(local_path)
        d = os.path.dirname(local_path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".pull.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, local_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return man

    def manifest(self, name: str) -> Manifest:
        try:
            return Manifest.from_json(self._get(name + MANIFEST_SUFFIX))
        except KeyError:
            raise TransportError(f"{self.describe()}: no manifest for "
                                 f"{name!r}")

    def exists(self, name: str) -> bool:
        """True only when the blob *and* its manifest are present. Push
        writes the payload first and the manifest last, so the manifest is
        the commit marker: a sync racing a mid-push shard sees it as
        not-yet-pushed (skipped) instead of pulling a manifest-less blob."""
        names = set(self._names())
        return name in names and name + MANIFEST_SUFFIX in names

    def list(self, prefix: str = "") -> List[str]:
        """Blob names (manifests hidden) under ``prefix``, sorted."""
        return sorted(n for n in self._names()
                      if n.startswith(prefix)
                      and not n.endswith(MANIFEST_SUFFIX))

    def list_shards(self, base_name: str) -> List[str]:
        """Shard-store objects for a base store name: ``fleet.jsonl`` →
        every ``fleet.shardNN.jsonl`` present in the channel."""
        root, ext = os.path.splitext(base_name)
        prefix = f"{root}.shard"
        return [n for n in self.list(prefix)
                if n.endswith(ext or ".jsonl")]

    def describe(self) -> str:
        return type(self).__name__


class LocalDirTransport(Transport):
    """A directory as the bucket — the shared-filesystem / rsync-target
    baseline. Writes are atomic (temp file + ``os.replace``), so a
    concurrent pull never sees a half-pushed blob."""

    def __init__(self, root: str):
        self.root = os.fspath(root)

    def _path(self, name: str) -> str:
        path = os.path.normpath(os.path.join(self.root, name))
        if os.path.commonpath([os.path.abspath(self.root),
                               os.path.abspath(path)]) != \
                os.path.abspath(self.root):
            raise TransportError(f"object name escapes the bucket: {name!r}")
        return path

    def _put(self, name: str, data: bytes) -> None:
        path = self._path(name)
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".push.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _get(self, name: str) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(name)

    def _delete(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def exists(self, name: str) -> bool:
        # two stats instead of the base class's full bucket walk — sync
        # probes every shard name, so this is O(1) per shard, not O(bucket)
        return (os.path.exists(self._path(name)) and
                os.path.exists(self._path(name + MANIFEST_SUFFIX)))

    def _names(self) -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for fn in files:
                if fn.endswith((".push.tmp", ".pull.tmp")):
                    continue
                out.append(fn if rel == "." else os.path.join(rel, fn))
        return out

    def describe(self) -> str:
        return f"dir://{self.root}"


class MemoryTransport(Transport):
    """In-process object store: buckets are class-level and shared by
    every instance with the same bucket name, so test "hosts" (or threads)
    reach the same channel without any shared directory — the stand-in for
    an HTTP/object-store transport."""

    _BUCKETS: Dict[str, Dict[str, bytes]] = {}
    _LOCK = threading.Lock()

    def __init__(self, bucket: str = "default"):
        self.bucket = bucket
        with self._LOCK:
            self._blobs = self._BUCKETS.setdefault(bucket, {})

    @classmethod
    def wipe(cls, bucket: Optional[str] = None) -> None:
        """Drop one bucket (or all) — test isolation."""
        with cls._LOCK:
            if bucket is None:
                cls._BUCKETS.clear()
            else:
                cls._BUCKETS.pop(bucket, None)

    def _put(self, name: str, data: bytes) -> None:
        with self._LOCK:
            self._blobs[name] = bytes(data)

    def _get(self, name: str) -> bytes:
        with self._LOCK:
            return self._blobs[name]  # KeyError when absent, per protocol

    def _delete(self, name: str) -> None:
        with self._LOCK:
            self._blobs.pop(name, None)

    def _names(self) -> List[str]:
        with self._LOCK:
            return list(self._blobs)

    def describe(self) -> str:
        return f"mem://{self.bucket}"


def resolve_transport(spec: Union[str, Transport]) -> Transport:
    """CLI/env spec → transport: ``mem://bucket`` → ``MemoryTransport``,
    ``dir://path`` or a bare path → ``LocalDirTransport``; an instance
    passes through."""
    if isinstance(spec, Transport):
        return spec
    spec = os.fspath(spec)
    if spec.startswith("mem://"):
        return MemoryTransport(spec[len("mem://"):] or "default")
    if spec.startswith("dir://"):
        spec = spec[len("dir://"):]
    if not spec:
        raise ValueError("empty transport spec")
    return LocalDirTransport(spec)

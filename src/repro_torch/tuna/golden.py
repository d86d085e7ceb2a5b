"""Golden schedule releases + kernel bundles of the built Hopper libraries.

The port's own copy of ``repro.tuna.golden``. A tuned store is a *moving*
target (the fleet appends to it continuously), so nothing downstream
should trust "whatever the store says today". A **golden release** freezes
the best-record set for one ``(target, cost-model version)`` into a
content-addressed artifact that is *blessed* by a regression gate:
promotion fails if any (op, target) schedule scores worse under the cost
model than the previous golden (or vanished from the store), unless the
regression is explicitly ``--waive``d, and every waiver is recorded in the
release manifest. Releases are the reference's files: same schema, same
payload digest, same names, so either package reads what the other
promotes. ``built_at`` is written at a fixed width (``cache._stamp_json``).

From a golden release, :func:`build_kernel_bundle` makes a **kernel
bundle**: one manifest-verified JSON artifact holding the full golden
schedule index, one entry per bundleable record (its kernel, its input
shapes and dtypes, its params, its blocks) and, where the reference holds
serialized XLA executables, the **compiled ``sm_90a`` kernel libraries**
that ``kernels/build.py`` makes (base64, each with its sha1). The host
launch code (tensor maps, grid sizing, shared-memory attributes) stays in
the libraries. A serve that installs the bundle (``launch/serve.py
--kernel-bundle``, ``kernels.ops.use_kernel_bundle``) writes each verified
library under ``build/`` and serves the kernels from it: **zero nvcc
runs** and zero cost-model evaluations at cold start (``core.tuner``'s
first lookup tier is the bundle's schedule index).

A bundle is tagged with its backend, ``"torch-cuda"`` or ``"torch-cpu"``,
names no jax backend has, so each package refuses the other's bundle. A
CUDA bundle also records the arch (``sm_90a``), the CUDA version and the
source digest of the libraries; it loads only on a card of compute
capability 9.0 in a checkout whose kernel sources have that digest. A
``"torch-cpu"`` bundle carries no library: its entries run the kernels'
plain versions at the record's blocks (the counterpart of the reference's
interpret-mode bundle, for tests), and a process that asks for the card
refuses it.

Promotion and the gate need neither torch nor a card; torch is imported by
the bundle half only, inside its functions.
"""
from __future__ import annotations

import base64
import dataclasses
import functools
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import op_registry
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.tuna.cache import (
    StaleSnapshotError,
    _payload,
    _stamp_json,
    read_snapshot_header,
)
from repro_torch.tuna.db import Key, ScheduleRecord, record_beats

GOLDEN_SCHEMA = "tuna-golden-v1"
GOLDEN_POINTER_SCHEMA = "tuna-golden-pointer-v1"
BUNDLE_SCHEMA = "tuna-kernel-bundle-v1"
BUNDLE_POINTER_SCHEMA = "tuna-bundle-pointer-v1"

# the backend tag of a bundle made for a device type; no jax backend has
# these names, so neither package takes the other's bundle for its own
BACKENDS = {"cuda": "torch-cuda", "cpu": "torch-cpu"}
ARCH = "sm_90a"                  # what the libraries are compiled for
CAPABILITY = (9, 0)              # the cards that run them


class GoldenError(RuntimeError):
    """A golden release operation failed (bad artifact, no records)."""


class BundleError(RuntimeError):
    """A kernel bundle failed to load or verify (corrupt payload, wrong
    schema, backend, device or kernel sources): never serve out of it."""


@dataclasses.dataclass(frozen=True)
class Regression:
    """One schedule that got worse (or vanished) vs the previous golden."""

    op: str
    target: str
    version: str
    kind: str                      # "slower" | "lost"
    old_score: float
    new_score: Optional[float] = None   # None when kind == "lost"
    waived_by: Optional[str] = None     # the --waive spec that accepted it

    @property
    def key(self) -> Key:
        return (self.op, self.target, self.version)

    def describe(self) -> str:
        if self.kind == "lost":
            return (f"{self.op} @ {self.target}: present in the previous "
                    f"golden (score {self.old_score:.3e}) but missing from "
                    f"the candidate — lost coverage")
        return (f"{self.op} @ {self.target}: score regressed "
                f"{self.old_score:.3e} -> {self.new_score:.3e} "
                f"({self.new_score / max(self.old_score, 1e-300):.3f}x)")


class GoldenRegressionError(GoldenError):
    """Promotion refused: schedules regressed vs the previous golden and
    were not waived. ``.regressions`` lists every blocking one."""

    def __init__(self, regressions: Sequence[Regression]):
        self.regressions = list(regressions)
        lines = "\n".join(f"  {r.describe()}" for r in self.regressions)
        super().__init__(
            f"{len(self.regressions)} schedule(s) regress vs the previous "
            f"golden release:\n{lines}\n"
            f"Fix the store (or the cost model), or accept explicitly with "
            f"--waive 'OP[@TARGET]' per regression — waivers are recorded "
            f"in the release manifest.")


def find_regressions(new_index: Dict[Key, ScheduleRecord],
                     old_records: Iterable[ScheduleRecord],
                     ) -> List[Regression]:
    """Gate a candidate best-record index against the previous golden's
    records: every key the old release blessed must still exist and must
    not score worse (scores are deterministic cost-model outputs, so the
    comparison is exact). New keys are always welcome."""
    out: List[Regression] = []
    for old in old_records:
        new = new_index.get(old.key)
        if new is None:
            out.append(Regression(op=old.op, target=old.target,
                                  version=old.version, kind="lost",
                                  old_score=old.score))
        elif new.score > old.score:
            out.append(Regression(op=old.op, target=old.target,
                                  version=old.version, kind="slower",
                                  old_score=old.score, new_score=new.score))
    return out


def waiver_matches(spec: str, reg: Regression) -> bool:
    """``--waive`` spec semantics: ``OP`` (exact op signature, every
    target) or ``OP@TARGET`` (one key). No globs: a waiver is a deliberate
    per-schedule exception, not a blanket."""
    if spec == reg.op:
        return True
    return spec == f"{reg.op}@{reg.target}"


@dataclasses.dataclass
class GoldenInfo:
    """What ``GoldenManager.promote`` did."""

    name: str
    path: str
    latest: str
    target: str
    sha1: str
    count: int
    rebuilt: bool
    repointed: bool
    predecessor: Optional[str]          # previous golden release name
    waived: List[Regression] = dataclasses.field(default_factory=list)
    gated_against: int = 0              # predecessor records checked


class GoldenManager:
    """Lifecycle of golden releases in a directory, one lineage per
    ``(target, COST_MODEL_VERSION)``.

    Names are content-addressed like snapshots
    (``golden.<target>.<cm-version>-<digest>.json``) with an atomic
    ``golden.<target>.latest.json`` pointer per target. A cost-model bump
    starts a fresh lineage: old scores are not comparable, so the first
    promotion under a new version has no predecessor to regress from."""

    def __init__(self, out_dir: str):
        self.out_dir = os.fspath(out_dir)

    # -- naming -----------------------------------------------------------

    def latest_path(self, target: str) -> str:
        return os.path.join(self.out_dir,
                            f"golden.{target}.latest.json")

    def release_name(self, target: str, sha1: str) -> str:
        return f"golden.{target}.{COST_MODEL_VERSION}-{sha1[:12]}.json"

    # -- reads ------------------------------------------------------------

    def current(self, target: str) -> Optional[Dict]:
        """Header of the release the ``latest`` pointer names, or None."""
        try:
            ptr = read_snapshot_header(self.latest_path(target))
        except (FileNotFoundError, ValueError):
            return None
        if ptr.get("schema") != GOLDEN_POINTER_SCHEMA:
            return None
        return ptr

    def load_release(self, path: str,
                     ) -> Tuple[Dict, List[ScheduleRecord]]:
        """Load + verify a golden release file (follows a ``latest``
        pointer): returns ``(header, records)``. A torn copy fails its
        payload digest here, never at the regression gate."""
        path = os.fspath(path)
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        if isinstance(obj, dict) and \
                obj.get("schema") == GOLDEN_POINTER_SCHEMA:
            target = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  obj["release"])
            return self.load_release(target)
        if not isinstance(obj, dict) or obj.get("schema") != GOLDEN_SCHEMA:
            schema = obj.get("schema") if isinstance(obj, dict) else None
            raise GoldenError(f"{path}: not a golden release "
                              f"(schema={schema!r}, want {GOLDEN_SCHEMA!r})")
        digest = hashlib.sha1(_payload(obj["records"]).encode()).hexdigest()
        if digest != obj.get("sha1"):
            raise GoldenError(
                f"{path}: golden release digest mismatch (corrupt or torn "
                f"copy); re-promote with `python -m repro_torch.tuna golden`")
        records = [ScheduleRecord.from_dict(r) for r in obj["records"]]
        return obj, records

    def previous(self, target: str,
                 ) -> Tuple[Optional[Dict], List[ScheduleRecord]]:
        """The predecessor release for this target *and* cost-model
        version (a pointer into another lineage yields none)."""
        ptr = self.current(target)
        if ptr is None or ptr.get("cost_model_version") != COST_MODEL_VERSION:
            return None, []
        try:
            return self.load_release(
                os.path.join(self.out_dir, ptr["release"]))
        except FileNotFoundError:
            return None, []

    # -- promotion --------------------------------------------------------

    def promote(self, records: Sequence[ScheduleRecord], target: str,
                waive: Sequence[str] = (), force: bool = False,
                source: str = "") -> GoldenInfo:
        """Freeze the best records for ``(target, COST_MODEL_VERSION)``
        into a golden release, gated against the previous golden.

        ``records`` may span targets/versions; only matching ones
        participate. Raises :class:`GoldenRegressionError` when any
        schedule regresses (slower score, or lost coverage) and no
        ``waive`` spec covers it; waived regressions are recorded in the
        release manifest. Re-promoting identical content is a no-op."""
        index: Dict[Key, ScheduleRecord] = {}
        for rec in records:
            if rec.target != target or rec.version != COST_MODEL_VERSION:
                continue
            cur = index.get(rec.key)
            if cur is None or record_beats(rec, cur):
                index[rec.key] = rec
        if not index:
            raise GoldenError(
                f"no records for target {target!r} under cost-model "
                f"version {COST_MODEL_VERSION!r} — nothing to promote")

        prev_hdr, prev_records = self.previous(target)
        prev_name = (self.release_name(target, prev_hdr["sha1"])
                     if prev_hdr else None)
        waived: List[Regression] = []
        blocking: List[Regression] = []
        for reg in find_regressions(index, prev_records):
            spec = next((w for w in waive if waiver_matches(w, reg)), None)
            if spec is not None:
                waived.append(dataclasses.replace(reg, waived_by=spec))
            else:
                blocking.append(reg)
        if blocking:
            raise GoldenRegressionError(blocking)

        best = [index[k] for k in sorted(index)]
        payload = [dataclasses.asdict(r) for r in best]
        digest = hashlib.sha1(_payload(payload).encode()).hexdigest()
        name = self.release_name(target, digest)
        path = os.path.join(self.out_dir, name)
        rebuilt = force or not os.path.exists(path)
        if rebuilt:
            _atomic_write_json(path, {
                # header-first like snapshots: identity fields come before
                # the record array so read_snapshot_header stays cheap
                "schema": GOLDEN_SCHEMA,
                "target": target,
                "cost_model_version": COST_MODEL_VERSION,
                "count": len(payload),
                "sha1": digest,
                "built_at": None,  # written at a fixed width by _stamp_json
                "source": source,
                "predecessor": prev_name,
                "waivers": [dataclasses.asdict(w) for w in waived],
                "records": payload,
            }, built_at=round(time.time(), 3))
        cur = self.current(target)
        repointed = cur is None or cur.get("release") != name
        if repointed:
            _atomic_write_json(self.latest_path(target), {
                "schema": GOLDEN_POINTER_SCHEMA,
                "release": name,
                "target": target,
                "sha1": digest,
                "count": len(payload),
                "cost_model_version": COST_MODEL_VERSION,
            }, sort_keys=True)
        return GoldenInfo(
            name=name, path=path, latest=self.latest_path(target),
            target=target, sha1=digest, count=len(payload), rebuilt=rebuilt,
            repointed=repointed, predecessor=prev_name,
            waived=waived, gated_against=len(prev_records))

    def publish(self, transport, info: GoldenInfo,
                bundle: Optional["BundleInfo"] = None) -> List:
        """Push a promoted release (payload before pointer) and optionally
        its kernel bundle over a transport. Returns the manifests."""
        from repro_torch.tuna.transport import resolve_transport

        t = resolve_transport(transport)
        manifests = [t.push(info.path, info.name)]
        manifests.append(t.push(info.latest,
                                os.path.basename(info.latest)))
        if bundle is not None:
            manifests.append(t.push(bundle.path, bundle.name))
            manifests.append(t.push(bundle.latest,
                                    os.path.basename(bundle.latest)))
        return manifests


def _atomic_write_bytes(path: str, data: bytes, suffix: str) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_write_json(path: str, obj: Dict, sort_keys: bool = False,
                       built_at: Optional[float] = None) -> None:
    """Write ``obj`` as one JSON line (temp file + replace); a
    ``"built_at": null`` in it takes ``built_at`` at a fixed width."""
    text = _stamp_json(json.dumps(obj, default=float, sort_keys=sort_keys),
                       built_at)
    _atomic_write_bytes(path, (text + "\n").encode("utf-8"), ".golden.tmp")


# -- kernel bundles ---------------------------------------------------------


def _kernel_dtypes() -> Dict:
    """The dtypes the Hopper kernels take, by their name in bundle keys:
    ``op_registry.DTYPE_BY_BYTES``'s ``"bfloat16"``/``"float32"`` (the names
    the bundle hooks write, never ``str(torch.dtype)``) and ``"float16"``,
    which no record's signature names (its width is bf16's) but a call's
    tensors may."""
    import torch

    return {op_registry.DTYPE_BY_BYTES[2]: torch.bfloat16,
            op_registry.DTYPE_BY_BYTES[4]: torch.float32,
            "float16": torch.float16}


def dtype_name(dtype) -> Optional[str]:
    """A torch dtype's name in bundle keys (``_kernel_dtypes``); None for a
    dtype no kernel takes. An f16 call's key names float16, so it misses
    every entry a bf16 record made."""
    return {v: k for k, v in _kernel_dtypes().items()}.get(dtype)


def _library(kernel: str, in_avals) -> str:
    """The library (a kernels/csrc source name) a plan's kernel launches
    from: its entry point's, by dtype and, for flash, head dim."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as km

    dtype = _kernel_dtypes()[in_avals[0][1]]
    if kernel == "matmul":
        return km.SOURCE[km.ENTRY[dtype]]
    return fa.SOURCE[fa.entry_for(dtype, in_avals[0][0][-1])]


@dataclasses.dataclass
class BundlePlan:
    """One record whose kernel a bundle can serve."""

    record: ScheduleRecord
    kernel: str                     # "matmul" | "flash"
    in_avals: List[Tuple[Tuple[int, ...], str]]   # per-arg (shape, dtype)
    params: Dict                    # semantic knobs of the call


def _cuda_skip(kernel: str, in_avals, config: Dict) -> Optional[str]:
    """Why the Hopper kernel cannot run this plan, or None."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as km

    dtypes = _kernel_dtypes()
    names = {dtype for _, dtype in in_avals}
    if len(names) != 1 or not names <= set(dtypes):
        return (f"the Hopper kernels take bfloat16, float16 or float32 inputs "
                f"alike, not {sorted(names)} (ROADMAP Queue B)")
    dtype = dtypes[names.pop()]
    if kernel == "matmul":
        (m, k), (_, n) = (shape for shape, _ in in_avals)
        try:
            bm, bn, bk = km.resolve_blocks(m, n, k, config["bm"], config["bn"],
                                           config["bk"])
        except ValueError as e:
            return f"blocks not built for this shape: {e}"
        if not km.built(bm, bn, bk, config.get("double_buffer", True), dtype):
            return (f"({bm}, {bn}, {bk}) is not built for {dtype}: its stages "
                    f"exceed shared memory")
        return None
    d = in_avals[0][0][-1]
    if not fa.supports_head_dim(d, dtype):
        return (f"head dim {d} is not built for {dtype} (multiples of 8 up to "
                f"{fa.MAX_HEAD_DIM[dtype]}; ROADMAP Queue B)")
    if not fa.built(config["block_q"], config["block_k"], d, dtype):
        return (f"blocks ({config['block_q']}, {config['block_k']}) not built "
                f"for {dtype} at head dim {d}")
    return None


def plan_bundle_entries(records: Iterable[ScheduleRecord],
                        device: str = "cuda",
                        ) -> Tuple[List[BundlePlan], List[Tuple[str, str]]]:
    """Partition golden records into kernel plans and ``(op, why)`` skips,
    resolving each record's op signature through the operator registry
    (``OpDef.bundle_fn`` reconstructs shapes and dtypes). Families without
    a kernel, unparseable signatures and knob-mismatched records are
    skipped with a reason, and so, for ``device="cuda"``, are records the
    Hopper kernels cannot run (other dtypes, unbuilt blocks or head dims). A skip
    still rides in the bundle's schedule index and never refuses the
    release."""
    plans: List[BundlePlan] = []
    skipped: List[Tuple[str, str]] = []
    for rec in records:
        try:
            spec = op_registry.bundle_for(rec.op, rec.config)
        except op_registry.BundleSkip as e:
            skipped.append((rec.op, e.reason))
            continue
        in_avals = [(tuple(shape), dtype) for shape, dtype in spec.in_avals]
        why = (_cuda_skip(spec.kernel, in_avals, rec.config)
               if device == "cuda" else None)
        if why is not None:
            skipped.append((rec.op, why))
            continue
        plans.append(BundlePlan(record=rec, kernel=spec.kernel,
                                in_avals=in_avals, params=dict(spec.params)))
    return plans, skipped


def _exec_key(kernel: str, in_avals: Sequence[Tuple[Sequence[int], str]],
              params: Optional[Dict] = None) -> str:
    """Canonical runtime-lookup key for a bundle entry: kernel family +
    concrete input (shape, dtype) list + the semantic knobs of the call.
    Built identically by ``build_kernel_bundle`` and the dispatch site."""
    return json.dumps({
        "kernel": kernel,
        "in": [[list(shape), str(dtype)] for shape, dtype in in_avals],
        "params": dict(params or {}),
    }, sort_keys=True, default=float)


def _device_type(device) -> str:
    kind = str(device).split(":")[0]
    if kind not in BACKENDS:
        raise ValueError(f"unsupported device {device!r}; want cuda or cpu")
    return kind


@dataclasses.dataclass
class BundleInfo:
    name: str
    path: str
    latest: str
    target: str
    sha1: str
    entries: int
    schedules: int
    skipped: List[Tuple[str, str]]
    libraries: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    #   source name -> {"file", "sha1", "bytes"} (empty for a CPU bundle)
    bytes: int = 0                  # the bundle file's size


def build_kernel_bundle(records: Sequence[ScheduleRecord], out_dir: str,
                        target: str, golden_name: Optional[str] = None,
                        device: str = "cuda") -> BundleInfo:
    """Bundle every golden record a kernel can serve, with the libraries
    they launch from.

    The artifact is one JSON file: the header (schema, digest, backend,
    and for the card the arch, CUDA version and source digest), the full
    golden **schedule index** (so the bundle alone is a lookup tier), one
    **entry** per bundled record, and for ``device="cuda"`` the
    **libraries**: each kernel source's ``sm_90a`` library as
    ``kernels/build.py`` builds it (this needs ``nvcc`` and raises without
    it; no card is read), base64 with its sha1. ``device="cpu"`` makes a
    bundle with no library whose entries run the plain versions."""
    import torch

    from repro_torch.kernels import build

    kind = _device_type(device)
    plans, skipped = plan_bundle_entries(records, device=kind)
    if skipped:
        reasons: Dict[str, int] = {}
        for _, why in skipped:
            reasons[why] = reasons.get(why, 0) + 1
        detail = "; ".join(f"{n}x {why}" for why, n in sorted(reasons.items()))
        print(f"[golden] {len(skipped)} of {len(records)} record(s) "
              f"not bundleable, kept schedule-index-only: {detail}",
              file=sys.stderr)
    libraries: Dict[str, Dict] = {}
    if kind == "cuda":
        build.build()
        for name in build.SOURCES:
            blob = build.library_path(name).read_bytes()
            libraries[name] = {
                "file": build.library_path(name).name,
                "sha1": hashlib.sha1(blob).hexdigest(),
                "bytes": len(blob),
                "b64": base64.b64encode(blob).decode("ascii"),
            }
    entries = []
    for plan in plans:
        lib = _library(plan.kernel, plan.in_avals) if kind == "cuda" else None
        entries.append({
            "op": plan.record.op,
            "kernel": plan.kernel,
            "target": plan.record.target,
            "version": plan.record.version,
            "config": dict(plan.record.config),
            "score": float(plan.record.score),
            "in_avals": [[list(shape), dtype]
                         for shape, dtype in plan.in_avals],
            "params": dict(plan.params),
            "library": lib,
            "library_sha1": libraries[lib]["sha1"] if lib else None,
        })
    schedules = [dataclasses.asdict(r) for r in records]
    # the reference's payload: its loader verifies a port bundle's digest
    # and then refuses the backend; the libraries are bound by the entries'
    # library_sha1 and each one's own sha1
    digest = hashlib.sha1(
        _payload(entries + schedules).encode()).hexdigest()
    name = f"bundle.{target}.{COST_MODEL_VERSION}-{digest[:12]}.json"
    path = os.path.join(out_dir, name)
    _atomic_write_json(path, {
        "schema": BUNDLE_SCHEMA,
        "target": target,
        "cost_model_version": COST_MODEL_VERSION,
        "golden": golden_name,
        "backend": BACKENDS[kind],
        "arch": ARCH if kind == "cuda" else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda if kind == "cuda" else None,
        "source_digest": build.source_digest(),
        "count": len(entries),
        "schedule_count": len(schedules),
        "sha1": digest,
        "built_at": None,  # written at a fixed width by _stamp_json
        "skipped_count": len(skipped),
        "skipped": [list(s) for s in skipped],
        "schedules": schedules,
        "entries": entries,
        "libraries": libraries,
    }, built_at=round(time.time(), 3))
    latest = os.path.join(out_dir, f"bundle.{target}.latest.json")
    _atomic_write_json(latest, {
        "schema": BUNDLE_POINTER_SCHEMA,
        "bundle": name,
        "target": target,
        "sha1": digest,
        "count": len(entries),
        "cost_model_version": COST_MODEL_VERSION,
    }, sort_keys=True)
    return BundleInfo(
        name=name, path=path, latest=latest, target=target, sha1=digest,
        entries=len(entries), schedules=len(schedules), skipped=skipped,
        libraries={n: {k: v for k, v in lib.items() if k != "b64"}
                   for n, lib in libraries.items()},
        bytes=os.path.getsize(path))


class KernelBundle:
    """A loaded kernel bundle: kernel entries + the golden schedule index.

    Two read surfaces, both lock-free after load:

    * :meth:`best` — ``(op, target, version)`` → golden ``ScheduleRecord``;
      what ``core.tuner`` consults as the first lookup tier. Immutable,
      like ``ScheduleCache``.
    * :meth:`executable` — ``(kernel, tensors, params)`` → a callable that
      launches the bundled kernel at the record's blocks, or ``None``. For
      a CUDA bundle its library is written under ``build/`` and installed
      (``kernels.build.install``) first, so a hit runs nvcc zero times.
    """

    immutable = True

    def __init__(self, obj: Dict, source: str = "<memory>",
                 libraries: Optional[Dict[str, bytes]] = None):
        self.source = source
        self.target = obj.get("target")
        self.golden = obj.get("golden")
        self.backend = obj.get("backend")
        self.arch = obj.get("arch")
        self.source_digest = obj.get("source_digest")
        self.cost_model_version = obj.get("cost_model_version")
        self.sha1 = obj.get("sha1")
        self.built_at = obj.get("built_at")
        self.device_type = next(
            (k for k, v in BACKENDS.items() if v == self.backend), None)
        self._libraries = dict(libraries or {})   # source name -> bytes
        self._library_sha1 = {n: lib["sha1"] for n, lib in
                              obj.get("libraries", {}).items()}
        self._installed: Dict[str, str] = {}      # source name -> path
        self._entries: Dict[str, Dict] = {}
        self._loaded: Dict[str, object] = {}      # exec key -> callable
        self._best: Dict[Key, ScheduleRecord] = {}
        for rec_obj in obj.get("schedules", []):
            rec = ScheduleRecord.from_dict(rec_obj)
            cur = self._best.get(rec.key)
            if cur is None or record_beats(rec, cur):
                self._best[rec.key] = rec
        for e in obj.get("entries", []):
            self._entries[_exec_key(e["kernel"], [
                (tuple(shape), dtype) for shape, dtype in e["in_avals"]
            ], e.get("params"))] = e
        self.exec_hits = 0
        self.exec_misses = 0
        self.hits = 0      # schedule-tier counters, mirroring ScheduleCache
        self.misses = 0

    # -- load / verify ----------------------------------------------------

    @classmethod
    def load(cls, path: str, device: str = "cuda") -> "KernelBundle":
        """Load + verify a bundle file (follows a ``latest`` pointer) for a
        process that runs on ``device``.

        Refuses: a file that is not a bundle or is torn (schema, JSON),
        a payload digest mismatch, a different ``COST_MODEL_VERSION``
        (``StaleSnapshotError``: the schedule tier would miss on every
        key), a foreign backend (a CUDA bundle asked for the CPU, a CPU
        one asked for the card, any bundle of the reference), kernel
        sources other than this checkout's, and for the card a library
        whose bytes do not match their sha1 or a card whose compute
        capability is not 9.0."""
        kind = _device_type(device)
        path = os.fspath(path)
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise BundleError(f"{path}: not a kernel bundle (not JSON: "
                              f"{e}; a torn copy?)") from None
        if isinstance(obj, dict) and \
                obj.get("schema") == BUNDLE_POINTER_SCHEMA:
            target = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  obj["bundle"])
            return cls.load(target, device=device)
        if not isinstance(obj, dict) or obj.get("schema") != BUNDLE_SCHEMA:
            schema = obj.get("schema") if isinstance(obj, dict) else None
            raise BundleError(f"{path}: not a kernel bundle "
                              f"(schema={schema!r}, want {BUNDLE_SCHEMA!r})")
        digest = hashlib.sha1(_payload(
            obj.get("entries", []) + obj.get("schedules", [])
        ).encode()).hexdigest()
        if digest != obj.get("sha1"):
            raise BundleError(
                f"{path}: bundle digest mismatch (corrupt or torn copy); "
                f"rebuild with `python -m repro_torch.tuna golden --bundle`")
        if obj.get("cost_model_version") != COST_MODEL_VERSION:
            raise StaleSnapshotError(
                f"{path}: kernel bundle was built for cost-model version "
                f"{obj.get('cost_model_version')!r} but this process runs "
                f"{COST_MODEL_VERSION!r}; re-promote and rebuild the "
                f"bundle (`python -m repro_torch.tuna golden --bundle`)")
        if obj.get("backend") != BACKENDS[kind]:
            raise BundleError(
                f"{path}: bundle was made for backend "
                f"{obj.get('backend')!r} but this process asks for "
                f"{BACKENDS[kind]!r} (device {kind!r}); rebuild the bundle "
                f"for this device")
        from repro_torch.kernels import build

        if obj.get("source_digest") != build.source_digest():
            raise BundleError(
                f"{path}: bundle was built from kernel sources with digest "
                f"{obj.get('source_digest')!r}, this checkout's is "
                f"{build.source_digest()!r}; a library built from other "
                f"sources must not serve — rebuild the bundle")
        libraries: Dict[str, bytes] = {}
        if kind == "cuda":
            import torch

            from repro_torch.hw import resolve_device

            resolve_device("cuda")
            cap = tuple(torch.cuda.get_device_capability())
            if cap != CAPABILITY or obj.get("arch") != ARCH:
                raise BundleError(
                    f"{path}: bundle backend {BACKENDS[kind]!r} holds "
                    f"{obj.get('arch')!r} libraries, for compute capability "
                    f"{CAPABILITY}; this process's card has {cap}")
            libraries = _verified_libraries(path, obj)
        return cls(obj, source=path, libraries=libraries)

    # -- schedule tier (core.tuner consults this first) -------------------

    def best(self, op: str, target: str,
             version: str = COST_MODEL_VERSION) -> Optional[ScheduleRecord]:
        rec = self._best.get((op, target, version))
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def records(self) -> List[ScheduleRecord]:
        return [self._best[k] for k in sorted(self._best)]

    def add(self, *args, **kwargs):
        raise TypeError(
            "KernelBundle is an immutable release artifact; write to the "
            "ScheduleDatabase and re-promote (`python -m repro_torch.tuna "
            "golden --bundle`)")

    # -- libraries --------------------------------------------------------

    def install(self, names: Optional[Iterable[str]] = None) -> Dict[str, str]:
        """Write each library (default: all) to a content-addressed path
        under ``build/`` (atomically; a file already there is reused only
        if its bytes match the sha1) and install it for its source name.
        Returns the paths by source name; a CPU bundle installs nothing."""
        from repro_torch.kernels import build

        for name in (self._libraries if names is None else names):
            if name in self._installed:
                continue
            blob, sha1 = self._libraries[name], self._library_sha1[name]
            path = build.BUILD_DIR / "bundled" / f"{name}-{sha1}.so"
            if not (path.exists() and
                    hashlib.sha1(path.read_bytes()).hexdigest() == sha1):
                _atomic_write_bytes(str(path), blob, ".so.tmp")
            build.install(name, path)
            self._installed[name] = str(path)
        return dict(self._installed)

    def uninstall(self) -> None:
        """Remove this bundle's libraries from ``kernels.build`` where they
        are still the ones installed."""
        from repro_torch.kernels import build

        now = build.installed()
        for name, path in self._installed.items():
            if str(now.get(name)) == path:
                build.uninstall(name)
        self._installed = {}

    # -- executable tier (kernels.ops dispatches through this) ------------

    def executable(self, kernel: str, args: Sequence,
                   params: Optional[Dict] = None):
        """The bundled kernel matching ``kernel`` called on ``args`` (its
        tensors) with semantic ``params``, or ``None`` (the caller picks
        blocks itself): a miss for a shape, dtype or params no entry has,
        and for a tensor on another device type than the bundle's."""
        if any(a.device.type != self.device_type for a in args):
            self.exec_misses += 1
            return None
        key = _exec_key(kernel, [(tuple(a.shape), dtype_name(a.dtype))
                                 for a in args], params)
        fn = self._loaded.get(key)
        if fn is None:
            entry = self._entries.get(key)
            if entry is None:
                self.exec_misses += 1
                return None
            fn = self._entry_callable(key, entry)
        self.exec_hits += 1
        return fn

    def _entry_callable(self, key: str, entry: Dict):
        if entry.get("library"):
            self.install([entry["library"]])
        cfg = entry["config"]
        if entry["kernel"] == "matmul":
            from repro_torch.kernels.matmul import matmul

            fn = functools.partial(
                matmul, bm=cfg["bm"], bn=cfg["bn"], bk=cfg["bk"],
                double_buffer=cfg.get("double_buffer", True))
        elif entry["kernel"] == "flash":
            from repro_torch.kernels.flash_attention import flash_attention

            fn = functools.partial(
                flash_attention, causal=entry["params"]["causal"],
                scale=entry["params"]["scale"], block_q=cfg["block_q"],
                block_k=cfg["block_k"])
        else:
            raise BundleError(f"{self.source}: unknown kernel family "
                              f"{entry['kernel']!r} in {entry['op']!r}")
        self._loaded[key] = fn
        return fn

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Key) -> bool:
        return key in self._best

    def describe(self) -> str:
        libs = ", ".join(f"{n} {s[:12]}"
                         for n, s in sorted(self._library_sha1.items()))
        return (f"{len(self._entries)} kernel entries / "
                f"{len(self._best)} schedules "
                f"[{self.backend}, {self.cost_model_version}"
                + (f", {self.arch}, sources {self.source_digest}"
                   if self.arch else "") + "]"
                + (f"; libraries {libs}" if libs else "")
                + (f" from golden {self.golden}" if self.golden else ""))


def _verified_libraries(path: str, obj: Dict) -> Dict[str, bytes]:
    """Every library of a CUDA bundle, decoded and checked against its
    sha1, and every entry's library present with the sha1 it names."""
    from repro_torch.kernels import build

    libs = obj.get("libraries") or {}
    if sorted(libs) != sorted(build.SOURCES):
        raise BundleError(f"{path}: bundle holds libraries {sorted(libs)}, "
                          f"want one per kernel source {build.SOURCES}")
    out: Dict[str, bytes] = {}
    for name, lib in libs.items():
        try:
            blob = base64.b64decode(lib["b64"], validate=True)
        except (KeyError, ValueError) as e:
            raise BundleError(f"{path}: library {name!r} is not readable "
                              f"({e}); corrupt bundle") from None
        if hashlib.sha1(blob).hexdigest() != lib.get("sha1"):
            raise BundleError(f"{path}: library {name!r} does not match its "
                              f"sha1; corrupt bundle")
        out[name] = blob
    for e in obj.get("entries", []):
        lib = libs.get(e.get("library") or "")
        if lib is None or lib["sha1"] != e.get("library_sha1"):
            raise BundleError(f"{path}: entry {e['op']!r} names library "
                              f"{e.get('library')!r} "
                              f"({e.get('library_sha1')!r}), which the "
                              f"bundle does not hold")
    return out

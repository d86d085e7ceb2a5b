"""Declarative operator registry: one ``OpDef`` per tunable operator family.

The port's own copy of ``repro.core.op_registry``, held against it by
``tests/test_torch_core.py``.

Instead of hand-coding a ``Space`` subclass per kernel, an operator family is
described once by an :class:`OpDef` — its scalar attributes (shapes, dtype
width, flags), a knob generator (tile sizes / loop order / unroll /
double-buffer choices per target kind), a TIR builder template, optional
kernel-bundle reconstruction, learned-ranker knob features, and named tuning
presets.  In the reference the presets, the learned ranker's feature
columns, the kernel-bundle hook and the block-spec pickers all derive from
the registry; the port reads it from ``core/spaces.py``, ``core/zoo.py``,
``core/tuner.py`` and the flash block picker, and keeps the rest of the
schema so that signatures and records stay interchangeable with the
reference's.

The canonical signature grammar is ``family[k1=v1,k2=v2,...]`` with keys
sorted lexicographically; values may be int, bool (``True``/``False``) or a
restricted string token.  Signatures for the four legacy ops are byte-
identical to the pre-registry format, so every existing schedule-DB record,
snapshot and golden release loads unchanged.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import sys
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import numpy as np

# dtype widths the kernel bundler understands (bytes -> dtype name)
DTYPE_BY_BYTES: Dict[int, str] = {2: "bfloat16", 4: "float32"}

_SIG_RE = re.compile(r"([A-Za-z0-9_]+)\[([^\]]*)\]$")
_SIG_STR_VALUE_RE = re.compile(r"[A-Za-z0-9_.+-]+")

# attribute keys that are schedule state, never operator identity
_SIG_EXCLUDE = ("knobs", "target_kind", "name")


def _format_sig_value(key: str, value: Any) -> str:
    """Render one signature attribute deterministically.

    bools render as ``True``/``False`` (checked before int: bool is an int
    subclass), ints as decimal, strings must be plain tokens so the grammar
    stays unambiguous (no ``,``/``=``/``]``)."""
    if isinstance(value, bool):
        return "True" if value else "False"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        if not _SIG_STR_VALUE_RE.fullmatch(value):
            raise ValueError(
                f"signature attr {key}={value!r} is not a plain token")
        return value
    raise TypeError(f"unsupported signature attr type for {key}: {value!r}")


def _parse_sig_value(text: str) -> Any:
    if text == "True":
        return True
    if text == "False":
        return False
    try:
        return int(text)
    except ValueError:
        return text


def parse_signature(sig: str) -> Tuple[str, Dict[str, Any]]:
    """``"matmul[K=64,M=128,N=128,dtype_bytes=4]"`` -> ("matmul", attrs).

    Raises ``ValueError`` on anything that does not match the grammar."""
    m = _SIG_RE.fullmatch(sig.strip())
    if not m:
        raise ValueError(f"unparseable op signature: {sig!r}")
    name, inner = m.group(1), m.group(2)
    attrs: Dict[str, Any] = {}
    for field in filter(None, inner.split(",")):
        if "=" not in field:
            raise ValueError(f"bad signature field {field!r} in {sig!r}")
        k, v = field.split("=", 1)
        attrs[k] = _parse_sig_value(v)
    return name, attrs


class Space:
    """Base schedule space: a dict of named discrete knobs.

    ES operates on a continuous θ that ``decode`` buckets into knob choices;
    ``enumerate`` walks the cartesian product for exhaustive/top-k tuning."""

    name: str = "space"

    def __init__(self) -> None:
        self.knobs: Dict[str, List] = {}

    @property
    def dim(self) -> int:
        return len(self.knobs)

    def decode(self, theta: np.ndarray) -> Dict:
        cfg = {}
        for (name, choices), t in zip(self.knobs.items(), theta):
            # map R -> index via round+clip; theta 0 = centre of the list
            idx = int(round(float(t) + (len(choices) - 1) / 2.0))
            cfg[name] = choices[max(0, min(len(choices) - 1, idx))]
        return cfg

    def default_config(self) -> Dict:
        return {k: v[len(v) // 2] for k, v in self.knobs.items()}

    def enumerate(self, limit: Optional[int] = 10_000) -> Iterator[Dict]:
        """Yield knob configs; ``limit=None`` walks the full product.

        A truncated walk is reported loudly on stderr (and via
        ``enumeration_truncated``) instead of silently dropping the tail —
        ranking a 10k prefix of a 1M-config space is a very different
        experiment from ranking the space."""
        names = list(self.knobs)
        total = self.size()
        truncated = limit is not None and total > limit
        self._enumeration_truncated = truncated
        if truncated:
            print(
                f"[spaces] {self.signature()}: enumeration truncated to "
                f"{limit} of {total} configs; pass limit=None or "
                f"limit>=size() to cover the full space",
                file=sys.stderr,
            )
        for i, combo in enumerate(itertools.product(*self.knobs.values())):
            if truncated and i >= limit:
                return
            yield dict(zip(names, combo))

    @property
    def enumeration_truncated(self) -> bool:
        """True iff the most recent ``enumerate`` call dropped configs."""
        return getattr(self, "_enumeration_truncated", False)

    def size(self) -> int:
        n = 1
        for v in self.knobs.values():
            n *= len(v)
        return n

    def instantiate(self, cfg: Dict) -> Tuple[Any, Any]:
        raise NotImplementedError

    def signature(self) -> str:
        """Canonical operator signature, e.g. ``matmul[K=256,M=256,N=256,
        dtype_bytes=4]`` — the ``op`` key of `repro.tuna` schedule records.

        Built from the scalar attributes that define the operator *instance*
        (shapes, dtype width, bool/str flags such as ``causal``), not the
        schedule knobs and not ``target_kind`` (the record's ``target`` field
        already pins the hardware)."""
        attrs = {
            k: v for k, v in vars(self).items()
            if not k.startswith("_") and k not in _SIG_EXCLUDE
            and isinstance(v, (int, str))
        }
        inner = ",".join(
            f"{k}={_format_sig_value(k, attrs[k])}" for k in sorted(attrs))
        return f"{self.name}[{inner}]"


# ---------------------------------------------------------------------------
# OpDef schema
# ---------------------------------------------------------------------------

_REQUIRED = object()


@dataclasses.dataclass(frozen=True)
class AttrSpec:
    """One scalar operator attribute (an axis extent, dtype width, or flag)."""

    name: str
    type: type = int
    default: Any = _REQUIRED

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED

    def coerce(self, value: Any) -> Any:
        if self.type is bool:
            if not isinstance(value, bool):
                raise ValueError(f"attr {self.name} expects bool, got {value!r}")
            return value
        if self.type is int:
            if isinstance(value, bool) or not isinstance(value, int):
                raise ValueError(f"attr {self.name} expects int, got {value!r}")
            return value
        if self.type is str:
            if not isinstance(value, str):
                raise ValueError(f"attr {self.name} expects str, got {value!r}")
            return value
        raise TypeError(f"unsupported attr type {self.type!r}")


@dataclasses.dataclass(frozen=True)
class KnobFeature:
    """How one schedule knob enters the learned ranker's feature vector.

    kind: "log2" (log2 of a tile size), "raw" (small count, e.g. unroll),
    "flag" (bool 0/1), "choice" (one-hot over ``choices``)."""

    name: str
    kind: str
    choices: Tuple[str, ...] = ()

    def feature_names(self) -> Tuple[str, ...]:
        if self.kind == "log2":
            return (f"log2_{self.name}",)
        if self.kind == "choice":
            return tuple(f"{self.name}_{c}" for c in self.choices)
        return (self.name,)


@dataclasses.dataclass(frozen=True)
class Preset:
    """A named operator instance used by ``configs/tuna_ops.OPERATORS``."""

    attrs: Mapping[str, Any]
    kind: str = "cpu"  # default target kind for the preset factory


class BundleSkip(Exception):
    """Raised by an OpDef bundle hook for records it cannot bundle."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class BundleSpec:
    """Kernel-bundle reconstruction for one schedule record: which kernel
    family serves it, its input avals ``((shape, dtype_name), ...)``
    and non-knob call params (e.g. ``causal``/``scale``)."""

    kernel: str
    in_avals: Tuple[Tuple[Tuple[int, ...], str], ...]
    params: Mapping[str, Any]


@dataclasses.dataclass
class OpDef:
    """Declarative description of one tunable operator family.

    ``knob_fn(attrs, target_kind)`` returns the knob dict; ``build_fn(attrs,
    cfg, target_kind)`` returns ``(Program, ScheduleMeta)``.  ``bundle_fn``
    (optional) maps ``(attrs, config)`` to a :class:`BundleSpec` or raises
    :class:`BundleSkip`; families without one are skipped at bundling time
    with a counted warning.  ``space_cls`` lets legacy families keep their
    historical constructor classes."""

    name: str
    attrs: Tuple[AttrSpec, ...]
    knob_fn: Callable[[Dict[str, Any], str], Dict[str, List]]
    build_fn: Callable[[Dict[str, Any], Dict, str], Tuple[Any, Any]]
    bundle_fn: Optional[Callable[[Dict[str, Any], Dict], BundleSpec]] = None
    knob_features: Tuple[KnobFeature, ...] = ()
    presets: Mapping[str, Preset] = dataclasses.field(default_factory=dict)
    space_cls: Optional[type] = None
    doc: str = ""

    def coerce_attrs(self, given: Mapping[str, Any]) -> Dict[str, Any]:
        known = {a.name for a in self.attrs}
        unknown = set(given) - known
        if unknown:
            raise ValueError(
                f"{self.name}: unknown attrs {sorted(unknown)}")
        out: Dict[str, Any] = {}
        for spec in self.attrs:
            if spec.name in given:
                out[spec.name] = spec.coerce(given[spec.name])
            elif spec.required:
                raise ValueError(f"{self.name}: missing attr {spec.name}")
            else:
                out[spec.name] = spec.default
        return out


class RegistrySpace(Space):
    """A ``Space`` materialised from an :class:`OpDef` + attribute values."""

    def __init__(self, opdef: OpDef, attrs: Mapping[str, Any],
                 target_kind: str = "tpu") -> None:
        super().__init__()
        self._opdef = opdef
        self.name = opdef.name
        for k, v in opdef.coerce_attrs(attrs).items():
            setattr(self, k, v)
        self.target_kind = target_kind
        self.knobs = opdef.knob_fn(self.attr_values(), target_kind)

    @property
    def opdef(self) -> OpDef:
        return self._opdef

    def attr_values(self) -> Dict[str, Any]:
        return {a.name: getattr(self, a.name) for a in self._opdef.attrs}

    def instantiate(self, cfg: Dict):
        return self._opdef.build_fn(self.attr_values(), cfg, self.target_kind)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, OpDef] = {}
_DEFINITIONS_LOADED = False


def register(opdef: OpDef) -> OpDef:
    """Register (or re-register, e.g. on module reload) an operator family."""
    _REGISTRY[opdef.name] = opdef
    return opdef


def _ensure_definitions() -> None:
    """Import the modules that register op families, exactly once.

    ``core.spaces`` registers the four legacy families first (their knob
    features pin the historical learned-ranker column prefix), then
    ``core.zoo`` adds ``moe_dispatch``, ``ssm_scan``, ``mlstm_chunk``,
    ``flash`` and ``flash_gqa``, in the reference's order."""
    global _DEFINITIONS_LOADED
    if _DEFINITIONS_LOADED:
        return
    _DEFINITIONS_LOADED = True
    import repro_torch.core.spaces  # noqa: F401  (registers legacy ops)
    import repro_torch.core.zoo  # noqa: F401  (registers the zoo families)


def families() -> Tuple[str, ...]:
    _ensure_definitions()
    return tuple(_REGISTRY)


def get(name: str) -> OpDef:
    _ensure_definitions()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown operator family {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def lookup(name: str) -> Optional[OpDef]:
    _ensure_definitions()
    return _REGISTRY.get(name)


def make_space(name: str, attrs: Mapping[str, Any],
               target_kind: str = "tpu") -> Space:
    """Build a schedule space for family ``name`` with the given attrs."""
    opdef = get(name)
    coerced = opdef.coerce_attrs(attrs)
    if opdef.space_cls is not None:
        return opdef.space_cls(**coerced, target_kind=target_kind)
    return RegistrySpace(opdef, coerced, target_kind)


def space_from_signature(sig: str, target_kind: str) -> Optional[Space]:
    """Reconstruct the schedule space a record's ``op`` signature came from.

    Returns ``None`` for unknown families or malformed signatures (callers
    skip those lineages)."""
    try:
        name, attrs = parse_signature(sig)
    except ValueError:
        return None
    opdef = lookup(name)
    if opdef is None:
        return None
    try:
        return make_space(name, attrs, target_kind)
    except (TypeError, ValueError):
        return None


def knob_feature_union() -> Tuple[KnobFeature, ...]:
    """Union of every registered op's knob features, group-major
    (log2 | raw | flag | choice), first-registration order within a group.

    Legacy families register first, so the historical learned-ranker feature
    layout is reproduced as a prefix and zoo knobs extend each group."""
    _ensure_definitions()
    groups: Dict[str, List[KnobFeature]] = {
        "log2": [], "raw": [], "flag": [], "choice": []}
    seen: Dict[str, KnobFeature] = {}
    for opdef in _REGISTRY.values():
        for kf in opdef.knob_features:
            if kf.kind not in groups:
                raise ValueError(f"{opdef.name}: bad knob feature kind "
                                 f"{kf.kind!r} for {kf.name!r}")
            prev = seen.get(kf.name)
            if prev is None:
                seen[kf.name] = kf
                groups[kf.kind].append(kf)
            elif prev.kind != kf.kind:
                raise ValueError(
                    f"knob {kf.name!r} registered as both {prev.kind!r} "
                    f"and {kf.kind!r}")
            elif kf.kind == "choice" and kf.choices != prev.choices:
                merged = prev.choices + tuple(
                    c for c in kf.choices if c not in prev.choices)
                merged_kf = dataclasses.replace(prev, choices=merged)
                groups["choice"][groups["choice"].index(prev)] = merged_kf
                seen[kf.name] = merged_kf
    return tuple(groups["log2"] + groups["raw"]
                 + groups["flag"] + groups["choice"])


def all_presets() -> Dict[str, Tuple[str, Preset]]:
    """``{preset_name: (family, Preset)}`` across the registry, in
    registration order (family) then declaration order (preset)."""
    _ensure_definitions()
    out: Dict[str, Tuple[str, Preset]] = {}
    for opdef in _REGISTRY.values():
        for pname, preset in opdef.presets.items():
            if pname in out:
                raise ValueError(f"duplicate preset name {pname!r} "
                                 f"({out[pname][0]} vs {opdef.name})")
            out[pname] = (opdef.name, preset)
    return out


def bundle_for(sig: str, config: Mapping[str, Any]) -> BundleSpec:
    """Resolve a schedule record to a kernel-bundle spec via its family's
    bundle hook.  Raises :class:`BundleSkip` with a human-readable reason for
    anything unbundleable (unknown family, missing hook, wrong knobs/dtype)."""
    try:
        name, attrs = parse_signature(sig)
    except ValueError as e:
        raise BundleSkip(str(e)) from None
    opdef = lookup(name)
    if opdef is None:
        raise BundleSkip("no kernel for this op family")
    if opdef.bundle_fn is None:
        raise BundleSkip("no kernel for this op family")
    try:
        coerced = opdef.coerce_attrs(attrs)
    except ValueError as e:
        raise BundleSkip(str(e)) from None
    return opdef.bundle_fn(coerced, dict(config))

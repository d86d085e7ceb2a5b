"""Static features from XLA HLO text (an own copy of
``repro.core.hlo_features``; pure text processing, no jax).

The reference's dry run reads the optimized HLO of ``jax.jit(...).lower(
...).compile()``; the learned ranker's graph-level columns
(``core/learned.hlo_counts``) read the same text from a record's
``meta["hlo"]``, so the port parses it exactly as the reference does:

* per-kind **collective statistics**: op counts, operand bytes (the
  roofline's collective term) and modeled per-device link bytes;
* layout-change ops (transpose/copy/bitcast-convert) and fusion counts;
* ``loop_scaled_collectives``: while-body contributions multiplied by the
  trip counts recovered from each loop's condition.

The ring model (operand and link bytes of one collective from its kind,
its result bytes and its group's size) is one function,
``ring_bytes``, which the port's dry run (``launch/dryrun.py``) also calls
for the collectives it counts in a traced step, so the port has one ring
model.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def _shape_bytes(text: str) -> float:
    """Sum of bytes over every shape literal in ``text``."""
    total = 0.0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def ring_bytes(kind: str, result_bytes: float, group: int) -> Tuple[float, float]:
    """(operand bytes, modeled ring link bytes) per device of one collective
    of ``kind`` whose result is ``result_bytes`` on each device, over a
    group of ``group`` devices: all-gather moves (s-1)/s of its result,
    reduce-scatter (s-1) times it, all-reduce 2(s-1)/s, all-to-all
    (s-1)/s, a permute all of it."""
    s = max(1, int(group))
    if kind == "all-gather":
        return result_bytes / s, result_bytes * (s - 1) / s
    if kind == "reduce-scatter":
        return result_bytes * s, result_bytes * (s - 1)
    if kind == "all-reduce":
        return result_bytes, 2.0 * result_bytes * (s - 1) / s
    if kind == "all-to-all":
        return result_bytes, result_bytes * (s - 1) / s
    if kind == "collective-permute":
        return result_bytes, result_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    operand_bytes: Dict[str, float]  # per-device operand payload, by kind
    link_bytes: Dict[str, float]  # modeled ring-traffic per device, by kind

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())


@dataclasses.dataclass
class HloFeatures:
    collectives: CollectiveStats
    n_fusions: int
    n_dots: int  # dot/convolution ops (post-fusion)
    n_layout_ops: int  # transpose/copy/bitcast — layout-change overhead
    n_while: int  # scan loops surviving in HLO


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    op_bytes: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
    link: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}

    for line in hlo_text.splitlines():
        stripped = line.strip()
        if "=" not in stripped:
            continue
        lhs_rhs = stripped.split("=", 1)
        rhs = lhs_rhs[1].lstrip()
        kind = None
        for k in COLLECTIVE_KINDS:
            # match `f32[..] all-reduce(` and async `all-reduce-start(`;
            # skip `-done` halves (payload already counted at -start)
            if re.search(rf"\b{k}(-start)?\(", rhs):
                kind = k
                break
        if kind is None:
            continue
        # result shape(s): everything left of the op name on the rhs
        result_part = rhs.split(kind)[0]
        result_bytes = _shape_bytes(result_part)
        if result_bytes == 0.0:
            continue
        s = max(1, _group_size(stripped))
        counts[kind] += 1
        operand, lk = ring_bytes(kind, result_bytes, s)
        op_bytes[kind] += operand
        link[kind] += lk
    return CollectiveStats(counts=counts, operand_bytes=op_bytes, link_bytes=link)


def parse_hlo(hlo_text: str) -> HloFeatures:
    n_fusion = len(re.findall(r"\bfusion\(", hlo_text))
    n_dots = len(re.findall(r"\b(?:dot|convolution)\(", hlo_text))
    n_layout = len(re.findall(r"\b(?:transpose|copy|bitcast-convert)\(", hlo_text))
    n_while = len(re.findall(r"\bwhile\(", hlo_text))
    return HloFeatures(
        collectives=parse_collectives(hlo_text),
        n_fusions=n_fusion,
        n_dots=n_dots,
        n_layout_ops=n_layout,
        n_while=n_while,
    )


def collective_bytes(hlo_text: str) -> float:
    """§Roofline numerator: summed per-device collective operand bytes."""
    return parse_collectives(hlo_text).total_operand_bytes


# ---------------------------------------------------------------------------
# while-loop trip scaling
# ---------------------------------------------------------------------------
# XLA's cost/byte accounting (and a naive text parse) counts a while body
# ONCE — a scanned 94-layer stack or a 16-step grad-accum loop under-reports
# its collectives by the trip count. We recover trip counts from each while's
# condition computation (the loop counter is compared against an s32
# constant) and propagate multipliers through nested loops.

_COMP_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\([^)]*\))?.*\{")
_WHILE_RE = re.compile(
    r"while\([^)]*\),\s*condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)"
)
_S32_CONST_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")


def _split_computations(hlo_text: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    current: str | None = None
    for raw in hlo_text.splitlines():
        line = raw.rstrip()
        if current is None:
            m = _COMP_HEADER_RE.match(line.strip())
            if m and line.strip().endswith("{"):
                current = m.group(1)
                comps[current] = []
        else:
            if line.strip() == "}":
                current = None
            else:
                comps[current].append(line)
    return comps


def loop_scaled_collectives(hlo_text: str, entry_hint: str = "") -> CollectiveStats:
    """Collective stats with while-body contributions multiplied by their
    recovered trip counts (nested loops compose multiplicatively)."""
    comps = _split_computations(hlo_text)

    # per-computation raw stats + while edges
    raw: Dict[str, CollectiveStats] = {}
    edges: Dict[str, List[Tuple[str, str]]] = {}  # comp -> [(cond, body)]
    for name, lines in comps.items():
        raw[name] = parse_collectives("\n".join(lines))
        edges[name] = [
            (m.group(1), m.group(2))
            for line in lines
            for m in [_WHILE_RE.search(line)]
            if m
        ]

    def trip_of(cond_name: str) -> int:
        lines = comps.get(cond_name, [])
        consts = [int(m.group(1)) for line in lines
                  for m in _S32_CONST_RE.finditer(line)]
        return max(consts) if consts else 1

    # multipliers: entry computations = those never referenced as a body
    bodies = {b for es in edges.values() for _, b in es}
    mult: Dict[str, float] = {n: 0.0 for n in comps}
    for n in comps:
        if n not in bodies:
            mult[n] = 1.0

    # propagate (few levels of nesting; iterate to fixpoint)
    for _ in range(8):
        changed = False
        for n, es in edges.items():
            for cond, body in es:
                new = mult.get(n, 0.0) * trip_of(cond)
                if new > mult.get(body, 0.0):
                    mult[body] = new
                    changed = True
        if not changed:
            break

    counts: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    op_bytes: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
    link: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
    for n, st in raw.items():
        m = mult.get(n, 0.0)
        if m <= 0:
            continue
        for k in COLLECTIVE_KINDS:
            counts[k] += int(st.counts[k] * m)
            op_bytes[k] += st.operand_bytes[k] * m
            link[k] += st.link_bytes[k] * m
    return CollectiveStats(counts=counts, operand_bytes=op_bytes, link_bytes=link)

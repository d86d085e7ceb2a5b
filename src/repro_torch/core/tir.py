"""Loop-nest tensor IR — the "program IR" side of Tuna's joint analysis.

The port's own copy of ``repro.core.tir``, held against it by
``tests/test_torch_core.py``.

This is a deliberately small TIR in the spirit of TVM's TIR: a tree of
``Loop`` nodes whose leaves are ``Compute`` statements made of affine
``Access``es. It preserves the complete loop structure (trip counts, loop
kinds) which the low-level code (VISA / HLO text) does not — exactly the split
the paper's Algorithm 1 exploits.

Affine accesses: every tensor dimension is indexed by a linear form
``Σ coeff_i * var_i + const``. This covers all programs in our transformation
spaces (tiled matmul / conv / attention / elementwise) and lets the locality
model (Alg. 2) compute exact footprints for regular tilings without ISL.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

# --------------------------------------------------------------------------
# Linear index expressions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinExpr:
    """Σ coeff * var + const with integer coefficients."""

    terms: Tuple[Tuple[str, int], ...]  # ((var, coeff), ...) sorted by var
    const: int = 0

    @staticmethod
    def of(*terms: Tuple[str, int], const: int = 0) -> "LinExpr":
        merged: Dict[str, int] = {}
        for var, coeff in terms:
            if coeff:
                merged[var] = merged.get(var, 0) + coeff
        return LinExpr(tuple(sorted((v, c) for v, c in merged.items() if c)), const)

    @staticmethod
    def var(name: str, coeff: int = 1) -> "LinExpr":
        return LinExpr.of((name, coeff))

    @staticmethod
    def const_(value: int) -> "LinExpr":
        return LinExpr((), value)

    def __add__(self, other: "LinExpr") -> "LinExpr":
        return LinExpr.of(*self.terms, *other.terms, const=self.const + other.const)

    def scaled(self, k: int) -> "LinExpr":
        return LinExpr(tuple((v, c * k) for v, c in self.terms), self.const * k)

    @property
    def vars(self) -> frozenset:
        return frozenset(v for v, _ in self.terms)

    def coeff(self, var: str) -> int:
        for v, c in self.terms:
            if v == var:
                return c
        return 0

    def evaluate(self, env: Mapping[str, int]) -> int:
        return self.const + sum(c * env[v] for v, c in self.terms)


# --------------------------------------------------------------------------
# IR nodes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorDecl:
    name: str
    shape: Tuple[int, ...]
    dtype_bytes: int = 4


@dataclasses.dataclass(frozen=True)
class Access:
    """A load or store of ``tensor[indices...]``."""

    tensor: str
    indices: Tuple[LinExpr, ...]
    is_store: bool = False

    @property
    def vars(self) -> frozenset:
        out: frozenset = frozenset()
        for ix in self.indices:
            out |= ix.vars
        return out

    def canonical(self, extents: Mapping[str, int]) -> Tuple:
        """Pattern key invariant to variable *names*: per dim, the sorted
        multiset of (coeff, extent) pairs + const. Two accesses with the same
        canonical key touch identical index sets over their loops."""
        dims = []
        for ix in self.indices:
            dims.append(
                (tuple(sorted((c, extents[v]) for v, c in ix.terms)), ix.const)
            )
        return (self.tensor, tuple(dims))


@dataclasses.dataclass(frozen=True)
class Compute:
    """A statement: op over loads producing a store.

    ``op`` ∈ {"fma", "add", "mul", "max", "exp", "rsqrt", "copy", "matmul_tile",
    "select"} — "matmul_tile" marks a statement the schedule maps onto the MXU
    (an (m,n,k) micro-tile contraction), everything else maps to vector units.
    """

    op: str
    output: Access
    inputs: Tuple[Access, ...]

    @property
    def accesses(self) -> Tuple[Access, ...]:
        return self.inputs + (self.output,)


Node = Union["Loop", Compute]


@dataclasses.dataclass(frozen=True)
class Loop:
    """A counted loop ``for var in range(extent)`` over ``body``.

    kind: "serial" | "parallel" | "vector" | "unroll" | "block".
    "block" marks the Pallas grid / DMA tile boundary: entering one iteration
    implies a DMA of the working tile HBM→VMEM (and store back for outputs).
    """

    var: str
    extent: int
    body: Tuple[Node, ...]
    kind: str = "serial"

    def walk_loops(self) -> Iterable["Loop"]:
        """Pre-order DFS over loop nodes (paper Alg. 1: PREORDER-DFS-FOR-LOOP)."""
        yield self
        for child in self.body:
            if isinstance(child, Loop):
                yield from child.walk_loops()


@dataclasses.dataclass(frozen=True)
class Program:
    tensors: Tuple[TensorDecl, ...]
    roots: Tuple[Loop, ...]
    name: str = "prog"

    def tensor(self, name: str) -> TensorDecl:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)

    def walk_loops(self) -> Iterable[Loop]:
        for r in self.roots:
            yield from r.walk_loops()

    def extents(self) -> Dict[str, int]:
        return {lp.var: lp.extent for lp in self.walk_loops()}

    def total_compute_statements(self) -> int:
        """Σ over Compute leaves of the product of enclosing extents."""
        total = 0

        def rec(node: Node, mult: int) -> None:
            nonlocal total
            if isinstance(node, Loop):
                for ch in node.body:
                    rec(ch, mult * node.extent)
            else:
                total += mult

        for r in self.roots:
            rec(r, 1)
        return total


# --------------------------------------------------------------------------
# Footprint counting for linear forms over iteration boxes
# --------------------------------------------------------------------------


def distinct_values(pairs: Sequence[Tuple[int, int]]) -> int:
    """Number of distinct values of ``Σ c_j v_j`` with ``0 <= v_j < n_j``.

    Exact for regular tilings: processing strides in ascending order and
    tracking (count, span), a level either falls inside the current span
    (dense extension → contiguous image) or beyond it (pure product). Our
    schedule spaces only generate such decompositions; ``tests/`` verifies
    exactness against brute-force enumeration with hypothesis.
    """
    pairs = [(abs(c), n) for c, n in pairs if c != 0 and n > 1]
    if not pairs:
        return 1
    pairs.sort()
    count = 1
    span = 0  # max attainable value so far (min is 0)
    for c, n in pairs:
        if c <= span + 1:
            # dense extension: contiguous if the image was contiguous; the
            # min() caps the estimate at the product bound otherwise
            span = span + c * (n - 1)
            count = min(span + 1, count * n)
        else:
            count = count * n
            span = span + c * (n - 1)
    return count


def footprint_elements(
    access_patterns: Iterable[Tuple],  # canonical keys (see Access.canonical)
) -> int:
    """Union cardinality over canonicalised patterns of one tensor.

    Identical patterns were deduplicated by the caller; distinct patterns are
    summed (an upper bound on the union — exact when patterns touch disjoint
    regions, the common case in our spaces)."""
    total = 0
    for _, dims in access_patterns:
        n = 1
        for coeff_extents, _const in dims:
            n *= distinct_values([(c, e) for c, e in coeff_extents])
        total += n
    return total


def access_footprint(access: Access, extents: Mapping[str, int], live_vars) -> int:
    """Footprint (elements) of one access with ``live_vars`` ranging and all
    other vars fixed."""
    n = 1
    for ix in access.indices:
        pairs = [(c, extents[v]) for v, c in ix.terms if v in live_vars]
        n *= distinct_values(pairs)
    return n

"""Analytical data-locality model — paper §III-A.2, Algorithm 2.

The port's own copy of ``repro.core.locality``, held against it by
``tests/test_torch_core.py``.

Bottom-up traversal of the loop/access tree computing, per tensor:

* **data footprint** — distinct elements touched in the subtree (exact affine
  box arithmetic instead of the paper's ISL; our transformation spaces only
  produce regular tilings for which this is exact — property-tested);
* **data movement** — elements that must cross the fast-memory boundary
  (L1 for CPU, VMEM for TPU), using the paper's rules:

  - leaf access: Dmov = Dfp = 1;
  - loop node whose single-iteration footprint fits in cache: Dmov = Dfp;
  - otherwise: Dmov = trip_count × Dmov(single iteration), except tensors
    whose reuse status survives (invariant to this loop var, own footprint
    fits, and the *interference* — the other tensors' per-iteration
    footprint — does not exceed cache: the paper's "continuous loop nodes
    that do not access this tensor" condition).

The returned movement (bytes) is the model's estimate of main-memory (HBM /
DRAM) traffic for one execution of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Tuple

from repro_torch.core.tir import (
    Access,
    Compute,
    Loop,
    Program,
    access_footprint,
)


@dataclasses.dataclass
class _TensorState:
    # canonical pattern key -> representative access
    patterns: Dict[Tuple, Access]
    mov: float  # elements moved within the subtree (one execution of it)
    reuse: bool

    def vars(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for acc in self.patterns.values():
            out |= acc.vars
        return out


@dataclasses.dataclass(frozen=True)
class LocalityReport:
    movement_bytes: float
    footprint_bytes: float
    per_tensor_movement: Mapping[str, float]  # bytes
    per_tensor_footprint: Mapping[str, float]  # bytes


def _footprint(state: _TensorState, extents, live) -> float:
    """Union footprint (elements) of a tensor's access patterns with
    ``live`` vars ranging. Identical canonical patterns are deduplicated;
    distinct patterns are summed (upper bound, exact for disjoint regions)."""
    total = 0.0
    seen = set()
    for key, acc in state.patterns.items():
        # re-canonicalise under the live set: two name-distinct patterns can
        # coincide once dead vars are fixed
        live_key = (
            acc.tensor,
            tuple(
                (
                    tuple(sorted((c, extents[v]) for v, c in ix.terms if v in live)),
                    ix.const,
                )
                for ix in acc.indices
            ),
        )
        if live_key in seen:
            continue
        seen.add(live_key)
        total += access_footprint(acc, extents, live)
    return total


def analyze_locality(program: Program, cache_bytes: int) -> LocalityReport:
    extents = program.extents()
    dtype_bytes = {t.name: t.dtype_bytes for t in program.tensors}

    def visit(node) -> Tuple[Dict[str, _TensorState], FrozenSet[str]]:
        """Returns (per-tensor state, vars live in this subtree)."""
        if isinstance(node, Compute):
            states: Dict[str, _TensorState] = {}
            for acc in node.accesses:
                key = acc.canonical(extents)
                st = states.get(acc.tensor)
                if st is None:
                    st = _TensorState(patterns={}, mov=0.0, reuse=True)
                    states[acc.tensor] = st
                if key not in st.patterns:
                    st.patterns[key] = acc
                    st.mov += 1.0  # leaf: Dmov = Dfp = 1
            return states, frozenset()

        assert isinstance(node, Loop)
        # ---- merge sequential children --------------------------------
        merged: Dict[str, _TensorState] = {}
        sub_vars: FrozenSet[str] = frozenset()
        child_movs: Dict[str, float] = {}
        for child in node.body:
            cstates, cvars = visit(child)
            sub_vars |= cvars
            if isinstance(child, Loop):
                sub_vars |= frozenset([child.var])
            for name, cst in cstates.items():
                st = merged.get(name)
                if st is None:
                    merged[name] = _TensorState(
                        patterns=dict(cst.patterns), mov=0.0, reuse=cst.reuse
                    )
                else:
                    st.patterns.update(cst.patterns)
                    st.reuse = st.reuse and cst.reuse
                child_movs[name] = child_movs.get(name, 0.0) + cst.mov

        live_iter = sub_vars  # this loop's var fixed; inner vars range
        live_full = sub_vars | frozenset([node.var])

        fp_iter = {
            name: _footprint(st, extents, live_iter) for name, st in merged.items()
        }
        fp_iter_all_bytes = sum(
            fp_iter[name] * dtype_bytes[name] for name in merged
        )

        for name, st in merged.items():
            fp_full = _footprint(st, extents, live_full)
            fp_full_bytes = fp_full * dtype_bytes[name]
            if fp_iter_all_bytes <= cache_bytes:
                # single-iteration working set resident => each element of the
                # full-loop footprint crosses the boundary exactly once
                st.mov = fp_full
                # reuse survives (deeper thrash impossible: monotone footprints)
            else:
                invariant = node.var not in st.vars()
                interference_bytes = (
                    fp_iter_all_bytes - fp_iter[name] * dtype_bytes[name]
                )
                if (
                    invariant
                    and st.reuse
                    and fp_full_bytes <= cache_bytes
                    and interference_bytes <= cache_bytes
                ):
                    st.mov = fp_full  # stays resident across iterations
                else:
                    # evicted between iterations: pay per-iteration movement
                    # (the merged children's movement) every trip
                    mov_iter = child_movs.get(name, fp_iter[name])
                    st.mov = node.extent * mov_iter
                    st.reuse = False
        return merged, live_full

    # virtual root over all top-level loops
    root = Loop(var="__root__", extent=1, body=tuple(program.roots), kind="serial")
    states, live = visit(root)
    live = live - frozenset(["__root__"])

    per_mov = {
        name: st.mov * dtype_bytes[name] for name, st in states.items()
    }
    per_fp = {
        name: _footprint(st, extents, live) * dtype_bytes[name]
        for name, st in states.items()
    }
    return LocalityReport(
        movement_bytes=sum(per_mov.values()),
        footprint_bytes=sum(per_fp.values()),
        per_tensor_movement=per_mov,
        per_tensor_footprint=per_fp,
    )

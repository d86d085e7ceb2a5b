"""Distributed-level Tuna: static selection of the *distribution* schedule
(an own copy of ``repro.core.sharding_tuner``).

The paper's Eq. 1 with a different (e, T_e): the program is a whole
(arch x shape) training/serving step, the transformation space is the
distribution knob grid (grad accumulation depth, sequence parallelism,
gradient compression), the "low-level code" is the dry run's record
(``launch/dryrun.run_cell``: the step traced on meta tensors), and the cost
model is the three-term roofline

    c(t) = max(compute_s, memory_s, collective_s) + lambda * max(0, HBM overflow)

every term derived statically from the record (loop-scaled collective
bytes) and datasheet constants, never from execution. The space is small
(<= 16 points), so the search is exhaustive.

The roofline terms come from ``structural_terms_fn``, which the caller
passes, as the reference's callers pass ``benchmarks/roofline``'s (not
ported: the repo-root benchmarks are held). The HBM limit is the H100's 80
GiB per card (``hw/gpu_h100.HBM_BYTES``), not the reference's 16 GiB TPU
figure.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.hw.gpu_h100 import HBM_BYTES

OVERFLOW_LAMBDA = 1e-9  # seconds per byte over HBM — dominates when violated


@dataclasses.dataclass
class DistResult:
    variant: Dict[str, Any]
    terms: Dict[str, float]
    cost: float
    record: Dict[str, Any]


def default_space(kind: str, base_accum: int) -> List[Dict[str, Any]]:
    if kind != "train":
        return [dict(sp_seq=v) for v in (False, True)]
    accums = sorted({max(1, base_accum // 4), max(1, base_accum // 2),
                     base_accum, base_accum * 2})
    grid = itertools.product(accums, (None, "int8"), (True, False))
    return [dict(accum_steps=a, grad_compression=g, sp_seq=s)
            for a, g, s in grid]


def evaluate_variant(arch: str, shape: str, variant: Dict[str, Any],
                     run_cell_fn, structural_terms_fn) -> DistResult:
    record = run_cell_fn(arch, shape, variant=variant, verbose=False)
    terms = structural_terms_fn(arch, shape, record)
    peak = record["mem"]["temp_bytes"] + record["mem"]["argument_bytes"]
    overflow = max(0.0, peak - HBM_BYTES)
    cost = max(terms["compute_s"], terms["memory_s"],
               terms["collective_s"]) + OVERFLOW_LAMBDA * overflow
    return DistResult(variant=variant, terms={
        **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        "hbm_peak_gib": peak / 2**30,
    }, cost=cost, record=record)


def tune_distribution(arch: str, shape: str, run_cell_fn,
                      structural_terms_fn,
                      space: Optional[List[Dict]] = None,
                      kind: str = "train",
                      base_accum: int = 16) -> Tuple[DistResult, List[DistResult]]:
    """Exhaustive static search; returns (best, all evaluated)."""
    space = space or default_space(kind, base_accum)
    results = []
    for variant in space:
        try:
            results.append(evaluate_variant(arch, shape, variant, run_cell_fn,
                                            structural_terms_fn))
        except Exception as e:  # noqa: BLE001 — a variant may not trace
            results.append(DistResult(variant=variant, terms={},
                                      cost=float("inf"),
                                      record={"status": "error",
                                              "error": str(e)[:300]}))
    best = min(results, key=lambda r: r.cost)
    return best, results

"""Hardware-related analytical cost model — paper §III, Eq. (2).

The port's own copy of ``repro.core.cost_model``, held against it by
``tests/test_torch_core.py``.

``score = a0*f0 + a1*f1 + ... + an*fn`` over features extracted *statically*
from the two-level analysis (TIR + VISA). Coefficients are derived from the
target's datasheet constants (instruction inverse-throughputs, clock, HBM
bandwidth) — no measurement on the target device is involved, which is the
paper's central constraint. Lower score = predicted faster.

Feature set:

  f0  ilp_cycles          VLIW/OoO scheduler makespan (Σ block × execs)
  f1  movement_bytes      Alg. 2 locality model (fast-mem boundary traffic)
  f2  unhidden_dma_cycles DMA not overlapped with compute (latency hiding)
  f3  mxu_ops / simd_fma  significant arithmetic instruction count
  f4  ldst_ops            significant data-movement instruction count
  f5  alignment_waste     tail-lane / MXU-padding waste fraction
  f6  occupancy_penalty   grid-vs-cores underutilisation (SM-occupancy analogue)
  f7  vmem_overflow       hard penalty: working set exceeds fast memory
  f8  dispatch_calls      grid/block-loop iterations — per-tile dispatch
                          overhead (dominant for XLA:CPU block executors;
                          small but real Pallas grid-step cost on TPU)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import ilp as ilp_mod
from repro_torch.core import instcount as ic_mod
from repro_torch.core import visa as visa_mod
from repro_torch.core.locality import analyze_locality
from repro_torch.core.tir import Program
from repro_torch.hw.target import HardwareTarget

# Version tag of the feature extractor + coefficient derivation. The
# reference keys its stored schedule records by this string; the port keeps
# "cm1" because its scores equal the reference's on the reference's targets
# (tests/test_torch_core.py pins the cm1 feature vector as a golden). Bump it
# whenever ``extract_features``/``coefficients``/``score`` change meaning.
COST_MODEL_VERSION = "cm1"


@dataclasses.dataclass(frozen=True)
class Features:
    ilp_cycles: float
    movement_bytes: float
    unhidden_dma_cycles: float
    arith_ops: float
    ldst_ops: float
    alignment_waste: float
    occupancy_penalty: float
    vmem_overflow: float
    parallel_extent: int
    dispatch_calls: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ScheduleMeta:
    """Side information the schedule instantiation passes to the model."""

    grid_size: int = 1
    double_buffer: bool = False
    parallel_extent: int = 1
    vmem_tile_bytes: int = 0  # per-grid-step working set claimed in fast mem


def extract_features(
    program: Program, target: HardwareTarget, meta: Optional[ScheduleMeta] = None
) -> Features:
    meta = meta or ScheduleMeta()
    visa = visa_mod.lower_program(program, target)
    counts = ic_mod.count_instructions(program, visa)
    ilp = ilp_mod.analyze_ilp(visa, target, double_buffer=meta.double_buffer)
    loc = analyze_locality(program, target.fast_mem_bytes)

    arith = sum(
        counts.counts.get(op, 0.0)
        for op in ("mxu.matmul", "vpu.fma", "vpu.add", "vpu.mul", "simd.fma",
                   "simd.add", "simd.mul")
    )
    ldst = sum(
        counts.counts.get(op, 0.0)
        for op in ("vpu.load", "vpu.store", "simd.load", "simd.store",
                   "simd.broadcast")
    )
    unhidden = ilp.dma_cycles * (1.0 - ilp.hidden_dma_frac)

    # SM-occupancy analogue: penalise grids that underfill or tail-wave cores
    cores = target.num_cores
    g = max(1, meta.grid_size)
    if g < cores:
        occupancy = (cores - g) / cores
    else:
        full, tail = divmod(g, cores)
        occupancy = 0.0 if tail == 0 else (1.0 - tail / cores) / (full + 1)

    buffers = 2 if meta.double_buffer else 1
    overflow = max(0.0, meta.vmem_tile_bytes * buffers - target.fast_mem_bytes)

    return Features(
        ilp_cycles=ilp.total_cycles,
        movement_bytes=loc.movement_bytes,
        unhidden_dma_cycles=unhidden,
        arith_ops=arith,
        ldst_ops=ldst,
        alignment_waste=counts.wasted_lane_frac,
        occupancy_penalty=occupancy,
        vmem_overflow=overflow,
        parallel_extent=meta.parallel_extent,
        dispatch_calls=float(meta.grid_size),
    )


def coefficients(target: HardwareTarget) -> Dict[str, float]:
    """Per-architecture coefficients from hardware constants (paper: derived
    from instruction latency tables; transferable across micro-architectures
    that share the SIMD ISA)."""
    cyc = 1.0 / target.clock_hz
    return {
        "ilp_cycles": cyc,
        "movement_bytes": 1.0 / target.hbm_bandwidth,
        "unhidden_dma_cycles": 0.5 * cyc,  # partially re-counted vs ILP term
        "arith_ops": 0.0,  # subsumed by ILP makespan; kept for calibration
        "ldst_ops": 0.0,
        "alignment_waste": 1e-4,  # dimensionless nudge between near-ties
        "occupancy_penalty": 1e-4,
        "vmem_overflow": 1.0,  # bytes over fast mem: effectively -inf fitness
        "parallel_extent": 0.0,
        # per-grid-step dispatch: ~scalar-core bookkeeping on TPU; the CPU
        # coefficient is calibrated (block dispatch dominates XLA:CPU loops)
        "dispatch_calls": 20.0 / target.clock_hz,
    }


def score(features: Features, target: HardwareTarget,
          coeffs: Optional[Dict[str, float]] = None) -> float:
    """Eq. (2): linear combination; divided by exploitable core parallelism
    (thread-level-parallelism term of the paper's CPU model)."""
    coeffs = coeffs or coefficients(target)
    f = features.as_dict()
    par = min(target.num_cores, max(1, features.parallel_extent))
    time_like = (
        f["ilp_cycles"] * coeffs["ilp_cycles"]
        + f["unhidden_dma_cycles"] * coeffs["unhidden_dma_cycles"]
        + f["arith_ops"] * coeffs["arith_ops"]
        + f["ldst_ops"] * coeffs["ldst_ops"]
        + f["dispatch_calls"] * coeffs.get("dispatch_calls", 0.0)
    ) / par + f["movement_bytes"] * coeffs["movement_bytes"]
    penalty = (
        f["alignment_waste"] * coeffs["alignment_waste"]
        + f["occupancy_penalty"] * coeffs["occupancy_penalty"]
        + f["vmem_overflow"] * coeffs["vmem_overflow"]
    )
    return time_like * (1.0 + f["alignment_waste"]) + penalty


def evaluate(program: Program, target: HardwareTarget,
             meta: Optional[ScheduleMeta] = None,
             coeffs: Optional[Dict[str, float]] = None) -> float:
    return score(extract_features(program, target, meta), target, coeffs)

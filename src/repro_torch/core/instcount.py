"""Joint IR/low-level parsing — paper Algorithm 1 (+ Algorithm 3).

The port's own copy of ``repro.core.instcount``, held against it by
``tests/test_torch_core.py``.

The VISA stream is flat: labels, register init (``scalar.addr`` with an init
value), register update (``scalar.loop``), and conditional jumps. Loop
structure must be *recovered*, exactly as the paper recovers it from x86 asm
or PTX:

1. **IDENTIFY-LOOP-LBB** — a basic block is a loop candidate iff some jump
   instruction ``j`` targets a label positioned *above* ``j`` (backward jump).
2. **Algorithm 3 trip-count recovery** — maintain a register-init map and a
   register-update map while scanning the stream; at an eligible condition
   check (the jump), derive iterations from (init value, update step, end
   bound).
3. **PATTERN-MATCH-LOOP** — walk the TIR's pre-order loop list and the
   recovered loop blocks in tandem, matching on iteration boundary. Loops the
   backend collapsed (vectorized / unrolled / tensorized) have no block and
   are skipped by the forward scan.
4. **COUNT-INSTRUCTION** — every instruction's dynamic count is the product
   of the trip counts of all recovered loop spans containing it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tir import Loop, Program
from repro_torch.core.visa import VInstr, VisaProgram

SIGNIFICANT = {
    # the paper's vfmadd/vmov (CPU) and fma/ld/st (PTX) analogues
    "mxu.matmul",
    "vpu.fma",
    "vpu.load",
    "vpu.store",
    "simd.fma",
    "simd.load",
    "simd.store",
    "simd.broadcast",
    "dma.load",
    "dma.store",
}


@dataclasses.dataclass
class LoopSpan:
    label: str
    start: int  # index of the label instruction
    end: int  # index of the backward jump
    trips: int


@dataclasses.dataclass
class InstReport:
    counts: Dict[str, float]  # opcode -> dynamic instruction count
    dma_bytes: float  # dynamic HBM<->VMEM DMA payload
    per_loop_simd: Dict[str, float]  # label -> dynamic significant instrs
    matched: List[Tuple[str, str]]  # (tir var, visa label) pairs (Alg. 1 result)
    wasted_lane_frac: float  # tail-lane waste, weighted by dynamic count
    spans: List[LoopSpan]
    multiplicity: List[float]  # per instruction index

    def total_significant(self) -> float:
        return sum(v for k, v in self.counts.items() if k in SIGNIFICANT)


def identify_loop_spans(visa: VisaProgram) -> List[LoopSpan]:
    """Faithful loop identification + Algorithm 3 trip recovery."""
    label_pos: Dict[str, int] = {}
    for idx, ins in enumerate(visa.instrs):
        if ins.opcode == "label":
            label_pos[ins.dest] = idx

    reg_init: Dict[str, int] = {}
    reg_update: Dict[str, int] = {}
    spans: List[LoopSpan] = []
    for idx, ins in enumerate(visa.instrs):
        if ins.opcode == "scalar.addr" and "init" in ins.meta:
            reg_init[ins.dest] = ins.meta["init"]
        elif ins.opcode == "scalar.loop" and "update" in ins.meta:
            reg_update[ins.dest] = ins.meta["update"]
        elif ins.opcode == "scalar.jump":
            tgt = ins.meta.get("target")
            if tgt in label_pos and label_pos[tgt] < idx:  # backward jump
                reg = ins.srcs[0]
                init = reg_init.get(reg, 0)
                step = reg_update.get(reg, 1)
                bound = ins.meta.get("bound", init + step)
                trips = max(1, math.ceil((bound - init) / step))
                spans.append(LoopSpan(tgt, label_pos[tgt], idx, trips))
    return spans


def _pattern_match(for_loop: Loop, span: LoopSpan) -> bool:
    """PATTERN-MATCH-LOOP: same iteration boundary."""
    return for_loop.extent == span.trips


def match_loops(program: Program, visa: VisaProgram) -> Tuple[List[Tuple[Loop, LoopSpan]], List[LoopSpan]]:
    """Algorithm 1 main procedure."""
    for_loops = list(program.walk_loops())  # PREORDER-DFS-FOR-LOOP
    spans = identify_loop_spans(visa)  # IDENTIFY-LOOP-LBB (stream order)
    matched: List[Tuple[Loop, LoopSpan]] = []
    idx = 0
    for span in spans:
        j = idx
        while j < len(for_loops):
            if _pattern_match(for_loops[j], span):
                matched.append((for_loops[j], span))
                idx = j + 1
                break
            j += 1  # collapsed (vector/unroll/tensor) loops have no block
    return matched, spans


def count_instructions(program: Program, visa: VisaProgram) -> InstReport:
    matched, spans = match_loops(program, visa)

    n = len(visa.instrs)
    mult = [1.0] * n
    for span in spans:
        for i in range(span.start, span.end + 1):
            mult[i] *= span.trips

    counts: Dict[str, float] = {}
    dma_bytes = 0.0
    waste_num = 0.0
    waste_den = 0.0
    per_loop: Dict[str, float] = {s.label: 0.0 for s in spans}
    for i, ins in enumerate(visa.instrs):
        if ins.opcode == "label":
            continue
        counts[ins.opcode] = counts.get(ins.opcode, 0.0) + mult[i]
        if ins.opcode.startswith("dma."):
            dma_bytes += ins.meta.get("bytes", 0) * mult[i]
        if "waste" in ins.meta:
            waste_num += ins.meta["waste"] * mult[i]
            waste_den += mult[i]
        if ins.opcode in SIGNIFICANT:
            for span in spans:
                if span.start <= i <= span.end:
                    per_loop[span.label] += mult[i]
    return InstReport(
        counts=counts,
        dma_bytes=dma_bytes,
        per_loop_simd=per_loop,
        matched=[(lp.var, sp.label) for lp, sp in matched],
        wasted_lane_frac=(waste_num / waste_den) if waste_den else 0.0,
        spans=spans,
        multiplicity=mult,
    )

"""Instruction-level-parallelism model — paper §III-A.3.

The port's own copy of ``repro.core.ilp``, held against it by
``tests/test_torch_core.py``.

A simplified fast out-of-order / VLIW scheduler run over every basic block:

* **data dependency builder** — two dependency graphs: true (RAW) and false
  (WAR + WAW) dependencies, over both registers and memory resources (tensor
  operands of loads/stores/DMAs);
* **instruction scheduler** — list scheduling under structural hazards (per-
  functional-unit issue pipelines with inverse-throughput occupancy + global
  issue width) and data hazards (RAW: consumer starts after producer
  completes; WAR/WAW: the later writer cannot start before the earlier
  instruction has issued).

The block's ILP cost is the makespan; the program cost is
Σ block_makespan × block_executions (paper: "product of ILP cost and number
of executions"). DMA instructions carry byte payloads — their completion
latency includes the bandwidth term, and with ``double_buffer=True`` their
true-dependency edges to same-tensor loads are dropped (the payload was
prefetched during the previous grid step — the TPU latency-hiding analogue of
the paper's GPU warp-latency-hiding feature).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from repro_torch.core.instcount import LoopSpan, identify_loop_spans
from repro_torch.core.visa import VInstr, VisaProgram
from repro_torch.hw.target import HardwareTarget


@dataclasses.dataclass(frozen=True)
class IlpReport:
    total_cycles: float
    blocks: Tuple[Tuple[int, float, float], ...]  # (start idx, makespan, execs)
    dma_cycles: float  # total cycles DMA units are busy
    compute_cycles: float  # total cycles compute units are busy
    hidden_dma_frac: float  # fraction of DMA busy-time overlapped with compute


def _effective_latency(ins: VInstr, target: HardwareTarget) -> float:
    unit, lat, _ = target.instruction_table[ins.opcode]
    if ins.opcode.startswith("dma."):
        return lat + ins.meta.get("bytes", 0) / target.bytes_per_cycle_hbm
    return lat


def schedule_block(
    instrs: List[VInstr], target: HardwareTarget, double_buffer: bool = False
) -> Tuple[float, float, float]:
    """Returns (makespan, dma_busy, compute_busy) in cycles."""
    table = target.instruction_table
    items = [ins for ins in instrs if ins.opcode in table]
    n = len(items)
    if n == 0:
        return 0.0, 0.0, 0.0

    # ---- data dependency builder -------------------------------------
    true_dep: List[List[int]] = [[] for _ in range(n)]  # RAW: j depends on i
    false_dep: List[List[int]] = [[] for _ in range(n)]  # WAR/WAW
    last_writer: Dict[str, int] = {}
    readers: Dict[str, List[int]] = {}
    last_mem_writer: Dict[str, int] = {}
    mem_readers: Dict[str, List[int]] = {}

    def is_mem_read(ins: VInstr) -> List[str]:
        if ins.opcode in ("vpu.load", "simd.load", "simd.broadcast"):
            return [ins.srcs[0]] if ins.srcs else []
        if ins.opcode == "dma.store":
            return [ins.srcs[0]] if ins.srcs else []
        return []

    def is_mem_write(ins: VInstr) -> List[str]:
        if ins.opcode in ("vpu.store", "simd.store"):
            return [ins.srcs[1]] if len(ins.srcs) > 1 else []
        if ins.opcode == "dma.load" and not double_buffer:
            return [ins.srcs[0]] if ins.srcs else []
        return []

    for j, ins in enumerate(items):
        mem_r = set(is_mem_read(ins))
        mem_w = set(is_mem_write(ins))
        for src in ins.srcs:
            if src in mem_r or src in mem_w:
                continue
            if src in last_writer:
                true_dep[j].append(last_writer[src])
            readers.setdefault(src, []).append(j)
        for t in mem_r:
            if t in last_mem_writer:
                true_dep[j].append(last_mem_writer[t])
            mem_readers.setdefault(t, []).append(j)
        if ins.dest is not None:
            if ins.dest in last_writer:
                false_dep[j].append(last_writer[ins.dest])  # WAW
            for r in readers.get(ins.dest, ()):
                false_dep[j].append(r)  # WAR
            last_writer[ins.dest] = j
            readers[ins.dest] = []
        for t in mem_w:
            if t in last_mem_writer:
                false_dep[j].append(last_mem_writer[t])
            for r in mem_readers.get(t, ()):
                false_dep[j].append(r)
            last_mem_writer[t] = j
            mem_readers[t] = []

    # ---- list scheduler ------------------------------------------------
    # per-unit pipelines: issue_width slots, each busy inv_throughput cycles
    unit_slots: Dict[str, List[float]] = {
        u.name: [0.0] * u.issue_width for u in target.units
    }
    issue_time = [0.0] * n
    finish_time = [0.0] * n
    global_issue: Dict[float, int] = {}

    order = list(range(n))  # program order as priority (list scheduling)
    scheduled = [False] * n
    dma_busy = 0.0
    compute_busy = 0.0
    for j in order:
        ins = items[j]
        unit, lat, inv_tp = table[ins.opcode]
        eff_lat = _effective_latency(ins, target)
        ready = 0.0
        for i in true_dep[j]:
            ready = max(ready, finish_time[i])
        for i in false_dep[j]:
            ready = max(ready, issue_time[i] + 1)
        # structural hazard: earliest free pipeline slot on the unit
        slots = unit_slots[unit]
        s = min(range(len(slots)), key=lambda k: slots[k])
        start = max(ready, slots[s])
        # global issue width: at most target.issue_width issues per cycle
        t = math.floor(start)
        while global_issue.get(t, 0) >= target.issue_width:
            t += 1
        start = max(start, float(t))
        global_issue[math.floor(start)] = global_issue.get(math.floor(start), 0) + 1
        occupancy = inv_tp + (
            ins.meta.get("bytes", 0) / target.bytes_per_cycle_hbm
            if ins.opcode.startswith("dma.")
            else 0.0
        )
        slots[s] = start + occupancy
        issue_time[j] = start
        finish_time[j] = start + eff_lat
        scheduled[j] = True
        if unit == "dma":
            dma_busy += occupancy
        elif unit in ("mxu", "vpu", "fma", "alu", "load", "store"):
            compute_busy += inv_tp

    return max(finish_time), dma_busy, compute_busy


def analyze_ilp(
    visa: VisaProgram, target: HardwareTarget, double_buffer: bool = False
) -> IlpReport:
    spans = identify_loop_spans(visa)
    n = len(visa.instrs)

    # block boundaries: labels and jumps terminate blocks
    boundaries = set()
    for i, ins in enumerate(visa.instrs):
        if ins.opcode in ("label", "scalar.jump"):
            boundaries.add(i)

    mult = [1.0] * n
    for span in spans:
        for i in range(span.start, span.end + 1):
            mult[i] *= span.trips

    blocks: List[Tuple[int, float, float]] = []
    total = 0.0
    dma_total = 0.0
    compute_total = 0.0
    hidden = 0.0
    start = 0
    i = 0
    while i <= n:
        if i == n or i in boundaries:
            seg = visa.instrs[start:i]
            if seg:
                execs = mult[start]
                makespan, dma_busy, comp_busy = schedule_block(
                    seg, target, double_buffer
                )
                if makespan > 0:
                    if double_buffer:
                        # steady state: DMA for step g+1 overlaps compute of g
                        makespan = max(makespan, dma_busy)
                        hidden += min(dma_busy, comp_busy) * execs
                    blocks.append((start, makespan, execs))
                    total += makespan * execs
                    dma_total += dma_busy * execs
                    compute_total += comp_busy * execs
            start = i + 1
        i += 1

    hidden_frac = (hidden / dma_total) if dma_total > 0 else 0.0
    return IlpReport(
        total_cycles=total,
        blocks=tuple(blocks),
        dma_cycles=dma_total,
        compute_cycles=compute_total,
        hidden_dma_frac=hidden_frac,
    )

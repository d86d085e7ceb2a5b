"""Hardware target description (the port's own copy of the reference schema).

A ``HardwareTarget`` carries what the static schedule choice reads: compute
geometry, functional units and per-opcode latency/throughput tables (read by
the ILP model, ``core/ilp.py``), the memory hierarchy and the chip's
roofline peaks. All values are published data-sheet numbers; nothing here is
measured.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class FunctionalUnit:
    name: str
    issue_width: int = 1  # ops accepted per cycle (structural hazard limit)


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    name: str
    kind: str  # "tpu" | "cpu" | "gpu" (SIMT) | "sm90" (tensor-core Hopper)

    # --- compute geometry ---
    vreg_shape: Tuple[int, int]  # (rows, lanes) of one vector issue
    mxu_shape: Tuple[int, int]  # matrix-unit tile (mma shape on a GPU)
    num_cores: int  # SMs on a GPU

    # --- functional units & instruction tables ---
    units: Tuple[FunctionalUnit, ...]
    # opcode -> (unit_name, latency_cycles, inverse_throughput_cycles)
    instruction_table: Mapping[str, Tuple[str, int, float]]
    issue_width: int

    # --- memory hierarchy ---
    fast_mem_bytes: int  # shared memory one GPU block may use
    fast_mem_line: int  # cache line / minimum staging granule, bytes
    hbm_bandwidth: float  # bytes / second
    clock_hz: float

    # --- roofline constants (chip level) ---
    peak_flops_bf16: float  # FLOP/s
    peak_flops_f32: float
    ici_bandwidth: float = 0.0  # bytes/s per inter-chip link

    def latency(self, opcode: str) -> int:
        return self.instruction_table[opcode][1]

    def unit_of(self, opcode: str) -> str:
        return self.instruction_table[opcode][0]

    def inv_throughput(self, opcode: str) -> float:
        return self.instruction_table[opcode][2]

    @property
    def bytes_per_cycle_hbm(self) -> float:
        return self.hbm_bandwidth / self.clock_hz

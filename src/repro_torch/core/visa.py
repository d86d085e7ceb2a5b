"""TIR → VISA: deterministic lowering to a virtual low-level ISA.

The port's own copy of ``repro.core.visa``, held against it by
``tests/test_torch_core.py``. One deliberate change: a ``tensor.*`` nest
is tensorized into ``mxu.matmul`` tiles whenever the target's instruction
table has that opcode (the reference asks ``kind == "tpu"``), so a
tensor-core GPU target (``hw/gpu_h100.py``, one m16n8k16 tile of tensor-core
work per opcode) is scored on its matrix unit instead of as SIMT FMAs. Of the
reference's targets only the TPU has ``mxu.matmul``, so they lower exactly
as before.

The paper's Algorithm 1 jointly parses high-level IR (loop structure) and
*generated low-level code* (exact instruction mix after register allocation,
vectorization, unrolling). On the TPU deployment target we cannot obtain real
Mosaic assembly without hardware, so the framework lowers the scheduled TIR
itself to a **virtual ISA** that models what the backend emits:

* VLIW TensorCore units: ``mxu.*`` (systolic matmul tiles), ``vpu.*``
  (8×128 vector ops), ``dma.*`` (async HBM↔VMEM copies with byte payloads),
  ``scalar.*`` (loop bookkeeping: init / update / compare+jump).
* For the CPU validation target the same lowering emits ``simd.*`` 256-bit
  ops (vfmadd/vmov analogues) — the paper's Intel model.

Crucially the lowering performs the code-gen transformations that make naive
IR-level instruction counting wrong (the paper's motivation for Alg. 1):

* **register allocation of accumulators** — an output invariant to a
  reduction loop is hoisted into a register: loads/stores leave the loop body;
* **vectorization** — a ``vector`` loop collapses into ⌈extent/lanes⌉ vector
  ops, with broadcast loads for invariant operands;
* **tensorization** — a ``tensor.m/n/k`` micro-nest collapses into MXU tile
  ops (⌈m/128⌉⌈n/128⌉⌈k/128⌉ instructions);
* **unrolling** — ``unroll`` loops are replicated inline (no backward jump).

The emitted stream is *flat*: labels, forward/backward jumps, and register
init/update instructions. Loop structure is NOT annotated — Algorithm 1 /
Algorithm 3 in ``instcount.py`` must genuinely recover it (backward-jump
detection + register init/update maps), as in the paper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tir import Access, Compute, Loop, Program, access_footprint
from repro_torch.hw.target import HardwareTarget

# opcode used by Compute.op -> (tpu vpu opcode, cpu simd opcode)
_OP_MAP = {
    "fma": ("vpu.fma", "simd.fma"),
    "add": ("vpu.add", "simd.add"),
    "mul": ("vpu.mul", "simd.mul"),
    "max": ("vpu.max", "simd.max"),
    "exp": ("vpu.exp", "simd.exp"),
    "rsqrt": ("vpu.rsqrt", "simd.rsqrt"),
    "copy": ("vpu.add", "simd.add"),
    "select": ("vpu.select", "simd.max"),
}


@dataclasses.dataclass
class VInstr:
    opcode: str
    dest: Optional[str] = None
    srcs: Tuple[str, ...] = ()
    meta: Dict = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # compact, assembly-ish
        m = f" ;{self.meta}" if self.meta else ""
        return f"{self.opcode} {self.dest or '_'} <- {','.join(self.srcs)}{m}"


@dataclasses.dataclass
class VisaProgram:
    instrs: List[VInstr]

    def text(self) -> str:
        return "\n".join(map(repr, self.instrs))


class _Lowerer:
    def __init__(self, program: Program, target: HardwareTarget):
        self.program = program
        self.target = target
        self.extents = program.extents()
        self.is_tpu = target.kind == "tpu"
        self.has_mxu = "mxu.matmul" in target.instruction_table
        self.out: List[VInstr] = []
        self._reg = 0
        self._label = 0
        self.lanes = target.vreg_shape[0] * target.vreg_shape[1]

    # -- helpers ------------------------------------------------------
    def reg(self, hint: str = "r") -> str:
        self._reg += 1
        return f"{hint}{self._reg}"

    def label(self) -> str:
        self._label += 1
        return f"LBB{self._label}"

    def emit(self, opcode, dest=None, srcs=(), **meta) -> VInstr:
        ins = VInstr(opcode, dest, tuple(srcs), meta)
        self.out.append(ins)
        return ins

    def _vop(self, op: str) -> str:
        pair = _OP_MAP[op]
        return pair[0] if self.is_tpu else pair[1]

    def _ldst(self, load: bool) -> str:
        if self.is_tpu:
            return "vpu.load" if load else "vpu.store"
        return "simd.load" if load else "simd.store"

    # -- main ---------------------------------------------------------
    def run(self) -> VisaProgram:
        for root in self.program.roots:
            self.lower_node(root)
        return VisaProgram(self.out)

    def lower_node(self, node) -> None:
        if isinstance(node, Compute):
            self.lower_compute(node, vector_var=None)
            return
        assert isinstance(node, Loop)
        kind = node.kind
        if kind.startswith("tensor."):
            self.lower_tensor_nest(node)
        elif kind == "vector":
            self.lower_vector_loop(node)
        elif kind == "unroll":
            for _ in range(node.extent):
                for ch in node.body:
                    self.lower_node(ch)
        elif kind == "block":
            self.lower_block_loop(node)
        else:  # serial / parallel
            self.lower_counted_loop(node)

    # -- counted loop with accumulator hoisting ------------------------
    def lower_counted_loop(self, node: Loop) -> None:
        prev_env = dict(getattr(self, "_acc_env", {}) or {})
        env = dict(prev_env)
        emitted: List[Tuple[Tuple, List[str]]] = []
        for key, n_regs in self._hoistable_accumulators(node):
            if key in env:
                continue  # already hoisted by an outer reduction loop
            regs = [self.reg("acc") for _ in range(n_regs)]
            for r in regs:
                self.emit(self._ldst(True), r, (key[0],), hoisted=True)
            env[key] = regs
            emitted.append((key, regs))

        ctr = self.reg("i")
        lbl = self.label()
        self.emit("scalar.addr", ctr, (), init=0)  # register init
        self.emit("label", lbl)
        self._acc_env = env
        for ch in node.body:
            self.lower_node(ch)
        self.emit("scalar.loop", ctr, (ctr,), update=1)  # register update
        self.emit(
            "scalar.jump", None, (ctr,), target=lbl, bound=node.extent, backward=True
        )

        for key, regs in emitted:
            for r in regs:
                self.emit(self._ldst(False), None, (r, key[0]), hoisted=True)
        self._acc_env = prev_env

    def _hoistable_accumulators(self, node: Loop):
        """Accumulators hoistable out of this loop: fma outputs invariant to
        the loop var, either as a direct child statement or through a single
        vector loop (one register per vector lane-group, as a real register
        allocator would keep)."""
        out = []
        for ch in node.body:
            if (
                isinstance(ch, Compute)
                and ch.op == "fma"
                and node.var not in ch.output.vars
            ):
                out.append(((ch.output.tensor, ch.output.indices), 1))
            elif (
                isinstance(ch, Loop)
                and ch.kind == "vector"
                and len(ch.body) == 1
                and isinstance(ch.body[0], Compute)
                and ch.body[0].op == "fma"
                and node.var not in ch.body[0].output.vars
            ):
                lanes = self.target.vreg_shape[1]
                n_regs = math.ceil(ch.extent / lanes)
                out.append(
                    ((ch.body[0].output.tensor, ch.body[0].output.indices), n_regs)
                )
        return out

    # -- vector (innermost) loop ---------------------------------------
    def lower_vector_loop(self, node: Loop) -> None:
        lanes = self.target.vreg_shape[1]  # lane dim only: 128 tpu / 8 cpu
        n_vec = math.ceil(node.extent / lanes)
        tail_waste = (n_vec * lanes - node.extent) / (n_vec * lanes)
        for ch in node.body:
            assert isinstance(ch, Compute), "vector loops must be innermost"
            for i in range(n_vec):
                self.lower_compute(
                    ch,
                    vector_var=node.var,
                    lane_waste=tail_waste if i == n_vec - 1 else 0.0,
                    vec_idx=i,
                )

    def lower_compute(
        self, c: Compute, vector_var, lane_waste: float = 0.0, vec_idx: int = 0
    ) -> None:
        acc_env = getattr(self, "_acc_env", {}) or {}

        def pick(regs: List[str]) -> str:
            return regs[vec_idx % len(regs)]

        in_regs = []
        for acc in c.inputs:
            key = (acc.tensor, acc.indices)
            if key in acc_env:
                in_regs.append(pick(acc_env[key]))
                continue
            r = self.reg("v")
            if vector_var is not None and vector_var not in acc.vars:
                op = "vpu.load" if self.is_tpu else "simd.broadcast"
            else:
                op = self._ldst(True)
            self.emit(op, r, (acc.tensor,), waste=lane_waste)
            in_regs.append(r)
        okey = (c.output.tensor, c.output.indices)
        if okey in acc_env:
            dest = pick(acc_env[okey])
            self.emit(self._vop(c.op), dest, tuple(in_regs) + (dest,), waste=lane_waste)
        else:
            dest = self.reg("v")
            if c.op == "fma":  # read-modify-write accumulate
                prev = self.reg("v")
                self.emit(self._ldst(True), prev, (c.output.tensor,), waste=lane_waste)
                self.emit(self._vop(c.op), dest, tuple(in_regs) + (prev,), waste=lane_waste)
            else:
                self.emit(self._vop(c.op), dest, tuple(in_regs), waste=lane_waste)
            self.emit(self._ldst(False), None, (dest, c.output.tensor), waste=lane_waste)

    # -- tensorized micro-nest -> MXU ----------------------------------
    def lower_tensor_nest(self, node: Loop) -> None:
        dims = {"m": 1, "n": 1, "k": 1}
        cur: object = node
        stmt = None
        while isinstance(cur, Loop) and cur.kind.startswith("tensor."):
            dims[cur.kind.split(".", 1)[1]] = cur.extent
            assert len(cur.body) == 1, "tensor nest must be a perfect nest"
            cur = cur.body[0]
        stmt = cur
        assert isinstance(stmt, Compute)
        if not self.has_mxu:
            # no matrix unit: re-lower as serial m / serial k / vector n
            inner = Loop(
                var=f"{node.var}__n",
                extent=dims["n"],
                body=(stmt,),
                kind="vector",
            )
            kl = Loop(var=f"{node.var}__k", extent=dims["k"], body=(inner,), kind="serial")
            ml = Loop(var=f"{node.var}__m", extent=dims["m"], body=(kl,), kind="serial")
            self.lower_node(ml)
            return
        mxu_m, mxu_n = self.target.mxu_shape
        tiles = (
            math.ceil(dims["m"] / mxu_m)
            * math.ceil(dims["n"] / mxu_n)
            * math.ceil(dims["k"] / mxu_m)
        )
        util = (dims["m"] * dims["n"] * dims["k"]) / (
            tiles * mxu_m * mxu_n * mxu_m
        )
        for _ in range(tiles):
            self.emit(
                "mxu.matmul",
                self.reg("t"),
                (stmt.inputs[0].tensor, stmt.inputs[1].tensor),
                util=util,
                m=dims["m"],
                n=dims["n"],
                k=dims["k"],
            )

    # -- block (grid/DMA tile) loop ------------------------------------
    def lower_block_loop(self, node: Loop) -> None:
        """Pallas-grid / cache-tile boundary: one DMA per tensor per grid
        step. Tensors invariant to the block var stay resident in VMEM across
        iterations (Pallas revisiting semantics) — their DMAs are hoisted
        outside the loop, like register-allocated accumulators."""
        inner_vars = self._vars_below(node)
        tensors_in, tensors_out = self._tensors_below(node)
        dtype = {t.name: t.dtype_bytes for t in self.program.tensors}

        def fp_bytes(acc: Access, name: str) -> int:
            return access_footprint(acc, self.extents, inner_vars) * dtype[name]

        for name, acc in tensors_in.items():
            if node.var not in acc.vars:  # resident across grid steps
                self.emit("dma.load", self.reg("d"), (name,),
                          bytes=fp_bytes(acc, name), hoisted=True)

        ctr = self.reg("g")
        lbl = self.label()
        self.emit("scalar.addr", ctr, (), init=0)
        self.emit("label", lbl)
        for name, acc in tensors_in.items():
            if node.var in acc.vars:
                self.emit("dma.load", self.reg("d"), (name,),
                          bytes=fp_bytes(acc, name))
        for ch in node.body:
            self.lower_node(ch)
        for name, acc in tensors_out.items():
            if node.var in acc.vars:
                self.emit("dma.store", None, (name,), bytes=fp_bytes(acc, name))
        self.emit("scalar.loop", ctr, (ctr,), update=1)
        self.emit(
            "scalar.jump", None, (ctr,), target=lbl, bound=node.extent, backward=True
        )
        for name, acc in tensors_out.items():
            if node.var not in acc.vars:
                self.emit("dma.store", None, (name,),
                          bytes=fp_bytes(acc, name), hoisted=True)

    def _vars_below(self, node: Loop):
        vs = set()

        def rec(n):
            if isinstance(n, Loop):
                vs.add(n.var)
                for ch in n.body:
                    rec(ch)

        for ch in node.body:
            rec(ch)
        return frozenset(vs)

    def _tensors_below(self, node: Loop):
        ins: Dict[str, Access] = {}
        outs: Dict[str, Access] = {}

        def rec(n):
            if isinstance(n, Loop):
                for ch in n.body:
                    rec(ch)
            else:
                for a in n.inputs:
                    ins.setdefault(a.tensor, a)
                outs.setdefault(n.output.tensor, n.output)
                if n.op == "fma":  # accumulation also reads the output
                    ins.setdefault(n.output.tensor, n.output)

        for ch in node.body:
            rec(ch)
        return ins, outs


def lower_program(program: Program, target: HardwareTarget) -> VisaProgram:
    return _Lowerer(program, target).run()

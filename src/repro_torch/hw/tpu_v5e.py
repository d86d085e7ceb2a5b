"""TPU v5e target description (the deployment target of the reference package).

The port's own copy of ``repro.hw.tpu_v5e``, held against it field by
field by ``tests/test_torch_core.py``.

Datasheet constants (public):
  * 197 TFLOP/s bf16, 394 TOPS int8 per chip
  * 819 GB/s HBM bandwidth, 16 GiB HBM
  * 1 TensorCore per chip, MXU 128x128 systolic array
  * VREG tile 8x128 (sublanes x lanes)
  * ~50 GB/s per ICI link
  * VMEM ~128 MiB aggregate scratch is NOT architectural; we use the
    per-core software-visible VMEM working budget of 16 MiB that Pallas
    kernels tile against (configurable at cost-model call sites).

The VISA (virtual TPU ISA) opcodes modelled here reflect the units a real
TensorCore schedules: the MXU (systolic matmul), the VPU (8x128 vector ALU),
two DMA queues (HBM<->VMEM), and the scalar core that drives them (VLIW).
Latencies are in core clock cycles at 940 MHz, derived from first principles:

  * ``mxu.matmul`` processes a 128x128x128 tile; the systolic array retires
    128 MACs/lane/cycle => a full tile has inverse throughput 128 cycles and
    pipeline latency ~2x128.
  * ``vpu.*`` ops operate on one 8x128 VREG per cycle.
  * ``dma.*`` latency models the HBM round-trip (~500 cycles) with
    per-VREG-line inverse throughput of VREG bytes / (HBM B/s / clock).
"""
from repro_torch.hw.target import FunctionalUnit, HardwareTarget

_CLOCK = 0.94e9

# bytes moved per dma.line op: one 8x128 f32 VREG tile = 4096 B
_VREG_BYTES = 8 * 128 * 4
_HBM_BPC = 819e9 / _CLOCK  # ~871 bytes/cycle
_DMA_LINE_CYCLES = max(1, round(_VREG_BYTES / _HBM_BPC))  # ~5

TPU_V5E = HardwareTarget(
    name="tpu_v5e",
    kind="tpu",
    vreg_shape=(8, 128),
    mxu_shape=(128, 128),
    num_cores=1,  # one TensorCore per v5e chip
    units=(
        FunctionalUnit("mxu", issue_width=1),
        FunctionalUnit("vpu", issue_width=2),
        FunctionalUnit("dma", issue_width=2),  # two DMA queues
        FunctionalUnit("scalar", issue_width=1),
    ),
    # opcode -> (unit, latency, inverse throughput)
    instruction_table={
        # one 128x128x128 bf16 tile-matmul. 197 TFLOP/s at 940 MHz is
        # ~209.6 kFLOP/cycle (4 MXUs); a 4.19-MFLOP tile retires in ~20
        # cycles; pipeline (fill+drain) latency ~140.
        "mxu.matmul": ("mxu", 140, 20),
        # VPU ops: one 8x128 VREG per cycle, short pipeline
        "vpu.fma": ("vpu", 4, 1),
        "vpu.add": ("vpu", 2, 1),
        "vpu.mul": ("vpu", 3, 1),
        "vpu.max": ("vpu", 2, 1),
        "vpu.exp": ("vpu", 8, 2),
        "vpu.rsqrt": ("vpu", 8, 2),
        "vpu.load": ("vpu", 3, 1),   # VMEM -> VREG
        "vpu.store": ("vpu", 3, 1),  # VREG -> VMEM
        "vpu.select": ("vpu", 2, 1),
        "vpu.iota": ("vpu", 2, 1),
        # async DMA: start costs issue slot; wait blocks on completion
        "dma.load": ("dma", 500, _DMA_LINE_CYCLES),   # HBM -> VMEM line
        "dma.store": ("dma", 500, _DMA_LINE_CYCLES),  # VMEM -> HBM line
        # scalar core bookkeeping
        "scalar.addr": ("scalar", 1, 1),
        "scalar.loop": ("scalar", 1, 1),
        "scalar.jump": ("scalar", 1, 1),
    },
    issue_width=4,  # VLIW bundle: scalar + vpu + mxu/dma slots
    fast_mem_bytes=16 * 1024 * 1024,  # VMEM working budget for one kernel
    fast_mem_line=_VREG_BYTES,
    hbm_bandwidth=819e9,
    clock_hz=_CLOCK,
    peak_flops_bf16=197e12,
    peak_flops_f32=49.25e12,
    ici_bandwidth=50e9,  # per link
)

# chip-count-level constants used by roofline reporting
HBM_BYTES = 16 * 1024**3
ICI_LINKS = 4  # 2D torus on v5e: 4 links/chip

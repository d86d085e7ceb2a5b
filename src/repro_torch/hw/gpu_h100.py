"""NVIDIA H100 SXM5 (80 GB) target description: the port's tensor-core GPU.

Data-sheet constants (NVIDIA H100 data sheet and Hopper architecture white
paper; dense rates, no sparsity, at the full 700 W power limit):

  * 132 SMs, 1.98 GHz boost clock; 4 warp schedulers per SM, one warp
    instruction each per cycle => ``issue_width=4``.
  * 227 KB (232,448 bytes) of shared memory usable by one block (opt-in
    above 48 KB as dynamic shared memory); 128 B lines.
  * HBM3: 3.35 TB/s.
  * Tensor cores: 989 TFLOP/s bf16, 4 per SM; 67 TFLOP/s f32 outside them.
  * NVLink 4: 18 links of 25 GB/s per direction each.

The instruction table follows the reference's A100 target
(``repro/hw/gpu_a100.py``), with the throughputs and widths derived from the
numbers above:

  * ``mxu.matmul`` is one m16n8k16 bf16 tile of tensor-core work
    (``mxu_shape=(16, 8)``; the VISA lowering tiles k by ``mxu_shape[0]``,
    i.e. k=16), which is 2*16*8*16 = 4096 FLOP. One tensor core retires
    989e12 / (132 SMs * 1.98 GHz * 4) = 946 FLOP/cycle, so a tile occupies
    it 4096 / 946 = 4.33 cycles; the ``mxu`` unit has the SM's 4 tensor
    cores as issue width. The kernel issues ``wgmma.m64n{bn}k16``, one
    warpgroup instruction per 64 x bn x 16 product, which is exactly
    4 * bn/8 of these tiles at the same rate per FLOP. The model keeps the
    m16n8k16 tile as its unit of counting: a unit of (64, bn) would change
    with the very knob being ranked.
  * ``dma.*`` models TMA staging HBM -> shared memory at the per-SM share
    of the memory rate: 3.35e12 / 1.98e9 / 132 = 12.8 B/cycle/SM, so one
    128 B line every 10 cycles; the issue width of 2 is the kernel's one or
    two stages in flight.
  * SIMT (``simd.*``, for families that do not tensorize): 128 FP32 lanes
    per SM (132 * 128 * 2 FLOP * 1.98 GHz = 67 TFLOP/s) => 4 FFMA warp
    instructions per cycle; 64 INT32 lanes => 2; 16 SFUs => one MUFU warp
    instruction every 2 cycles; shared memory serves 32 banks * 4 B = 128 B
    per cycle => one warp-wide load or store per cycle.

No data sheet gives latencies. The SIMT, DMA (400-cycle DRAM round trip)
and scalar latencies are the reference A100 table's; the ``mma`` latency of
32 cycles is an assumption of the same order. These are modelling inputs,
not measurements of this card.

``kind="sm90"`` marks a tensor-core GPU whose schedules are block tiles:
``core/spaces.py`` gives it the Hopper matmul knobs, and the VISA lowering
tensorizes because the table has ``mxu.matmul``. (``"gpu"`` stays the
reference's SIMT model.) ``core/tuner.tuned_matmul_blocks`` scores on this
target; the flash block picker in ``kernels/ops.py`` reads only its
shared-memory budget, clock and memory rate.
"""
from repro_torch.hw.target import FunctionalUnit, HardwareTarget

_CLOCK = 1.98e9
_SMS = 132
_LINE_BYTES = 128
_HBM_BPC_PER_SM = 3.35e12 / _CLOCK / _SMS  # ~12.8 bytes/cycle/SM
_DMA_LINE_CYCLES = max(1, round(_LINE_BYTES / _HBM_BPC_PER_SM))  # 10
_MMA_FLOP = 2 * 16 * 8 * 16  # one m16n8k16 tile
_TC_FLOP_PER_CYCLE = 989e12 / (_SMS * _CLOCK * 4)  # ~946 per tensor core
_MMA_CYCLES = _MMA_FLOP / _TC_FLOP_PER_CYCLE  # ~4.33

GPU_H100 = HardwareTarget(
    name="gpu_h100",
    kind="sm90",
    vreg_shape=(1, 32),  # one warp = 32 lanes
    mxu_shape=(16, 8),  # the m16n8k16 tile the model counts in
    num_cores=_SMS,
    units=(
        FunctionalUnit("mxu", issue_width=4),     # 4 tensor cores per SM
        FunctionalUnit("fma", issue_width=4),     # 128 FP32 lanes / 32
        FunctionalUnit("alu", issue_width=2),     # 64 INT32 lanes / 32
        FunctionalUnit("sfu", issue_width=1),     # 16 SFUs -> 1/2 warp-instr
        FunctionalUnit("lsu", issue_width=1),     # 128 B/cycle shared memory
        FunctionalUnit("dma", issue_width=2),     # TMA stages in flight
        FunctionalUnit("scalar", issue_width=4),  # 4 warp schedulers
    ),
    # opcode -> (unit, latency, inverse throughput), cycles at 1.98 GHz
    instruction_table={
        "mxu.matmul": ("mxu", 32, _MMA_CYCLES),
        "simd.fma": ("fma", 4, 1),
        "simd.add": ("fma", 4, 1),
        "simd.mul": ("fma", 4, 1),
        "simd.max": ("alu", 4, 1),
        "simd.exp": ("sfu", 10, 2),
        "simd.rsqrt": ("sfu", 10, 2),
        "simd.load": ("lsu", 28, 1),
        "simd.store": ("lsu", 28, 1),
        "simd.broadcast": ("lsu", 25, 1),
        "dma.load": ("dma", 400, _DMA_LINE_CYCLES),
        "dma.store": ("dma", 400, _DMA_LINE_CYCLES),
        "scalar.addr": ("scalar", 1, 1),
        "scalar.loop": ("scalar", 1, 1),
        "scalar.jump": ("scalar", 1, 1),
    },
    issue_width=4,
    fast_mem_bytes=232_448,
    fast_mem_line=_LINE_BYTES,
    hbm_bandwidth=3.35e12,
    clock_hz=_CLOCK,
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    ici_bandwidth=25e9,
)

# chip-level constants: the H100 SXM's 80 GB of HBM3 (80 GiB as the data
# sheet's 80 GB is counted, the figure the launcher's state-dtype rule uses)
HBM_BYTES = 80 * 1024**3

"""NVIDIA A100 (SXM4 40GB) target description (static third target).

The port's own copy of ``repro.hw.gpu_a100``, held against it field by
field by ``tests/test_torch_core.py``.

Datasheet / microbenchmark constants (public; NVIDIA Ampere whitepaper and
Jia et al.'s "Dissecting the NVIDIA Ampere GPU" latency tables):

  * 108 SMs at 1.41 GHz boost; 4 warp schedulers per SM (one warp
    instruction each per cycle).
  * Warp = 32 lanes; 64 FP32 FMA lanes per SM => 2 FFMA warp
    instructions/cycle; dependent-issue latency 4 cycles.
  * 16 SFUs per SM => one MUFU (exp/rsqrt) warp instruction every 2 cycles.
  * Combined 192 KiB L1/shared per SM, up to 164 KiB usable shared memory
    carveout; 128 B cache lines/sectors pairs.
  * HBM2e: 1555 GB/s; ~400-cycle DRAM round trip. ``dma.*`` models
    ``cp.async`` staging HBM -> shared memory, the Ampere analogue of the
    Pallas HBM->VMEM block copy: per-SM share of stream bandwidth is
    1555e9 / 1.41e9 / 108 ~= 10.2 B/cycle, so a 128 B line retires every
    ~13 cycles.
  * Tensor cores: 312 TFLOP/s bf16 dense; 19.5 TFLOP/s FP32 (non-TC).
  * NVLink 3: 25 GB/s per link per direction (12 links per GPU).

The cost model treats one SM as the core (``num_cores=108``): schedules earn
their parallel speedup through ``parallel_extent`` across SMs, matching how
the CUDA grid maps blocks to SMs. Lowering uses the generic ``simd.*`` path
(a warp is a 32-lane vector unit) plus ``dma.*`` for block-staging loops.
"""
from repro_torch.hw.target import FunctionalUnit, HardwareTarget

_CLOCK = 1.41e9

_LINE_BYTES = 128  # L2 sector pair / smem staging granule
_HBM_BPC_PER_SM = 1555e9 / _CLOCK / 108  # ~10.2 bytes/cycle/SM
_DMA_LINE_CYCLES = max(1, round(_LINE_BYTES / _HBM_BPC_PER_SM))  # ~13

GPU_A100 = HardwareTarget(
    name="gpu_a100",
    kind="gpu",
    vreg_shape=(1, 32),  # one warp = 32 lanes
    mxu_shape=(1, 32),
    num_cores=108,  # SMs; grid blocks spread across them
    units=(
        FunctionalUnit("fma", issue_width=2),    # 64 FP32 lanes / 32
        FunctionalUnit("alu", issue_width=2),    # 64 INT32 lanes / 32
        FunctionalUnit("sfu", issue_width=1),    # 16 SFUs -> 1/2 warp-instr
        FunctionalUnit("lsu", issue_width=2),    # LD/ST + L1 128 B/cycle
        FunctionalUnit("dma", issue_width=2),    # cp.async pipe depth
        FunctionalUnit("scalar", issue_width=4),  # 4 warp schedulers
    ),
    # opcode -> (unit, latency, inverse throughput), cycles at 1.41 GHz
    instruction_table={
        "simd.fma": ("fma", 4, 1),
        "simd.add": ("fma", 4, 1),
        "simd.mul": ("fma", 4, 1),
        "simd.max": ("alu", 4, 1),
        "simd.exp": ("sfu", 10, 2),
        "simd.rsqrt": ("sfu", 10, 2),
        "simd.load": ("lsu", 28, 1),   # smem/L1-hit latency
        "simd.store": ("lsu", 28, 1),
        "simd.broadcast": ("lsu", 25, 1),  # smem broadcast / uniform load
        # cp.async block staging: HBM round trip + per-line stream rate
        "dma.load": ("dma", 400, _DMA_LINE_CYCLES),
        "dma.store": ("dma", 400, _DMA_LINE_CYCLES),
        "scalar.addr": ("scalar", 1, 1),
        "scalar.loop": ("scalar", 1, 1),
        "scalar.jump": ("scalar", 1, 1),
    },
    issue_width=4,  # one instruction per scheduler per cycle
    fast_mem_bytes=164 * 1024,  # max shared-memory carveout per SM
    fast_mem_line=_LINE_BYTES,
    hbm_bandwidth=1555e9,
    clock_hz=_CLOCK,
    peak_flops_bf16=312e12,  # dense tensor-core bf16
    peak_flops_f32=19.5e12,
    ici_bandwidth=25e9,  # NVLink 3, per link per direction
)

# chip-level constants for roofline reporting
HBM_BYTES = 40 * 1024**3
NVLINKS = 12

"""Generic AVX2-class CPU target (validation target — we can measure on it).

The port's own copy of ``repro.hw.cpu_avx2``, held against it field by
field by ``tests/test_torch_core.py``.

Mirrors the paper's Intel CPU cost model: vfmadd/vmov SIMD counts, L1 cache
locality, OoO ILP with issue-width structural hazards. Latencies follow
published Skylake-class tables (Agner Fog):

  * 256-bit FMA: latency 4, two FMA ports => inverse throughput 0.5 (we use
    integer cycles: two `simd.fma` units of issue width 1 each is modelled as
    one unit with issue_width 2).
  * L1D 32 KiB, 64 B lines.
"""
from repro_torch.hw.target import FunctionalUnit, HardwareTarget

_CLOCK = 3.0e9

CPU_AVX2 = HardwareTarget(
    name="cpu_avx2",
    kind="cpu",
    vreg_shape=(1, 8),  # one ymm register = 8 f32 lanes
    mxu_shape=(1, 8),
    num_cores=1,  # per-core model; thread-level parallelism handled above
    units=(
        FunctionalUnit("fma", issue_width=2),    # ports 0+1
        FunctionalUnit("load", issue_width=2),   # ports 2+3
        FunctionalUnit("store", issue_width=1),  # port 4
        FunctionalUnit("alu", issue_width=2),
        FunctionalUnit("scalar", issue_width=2),
    ),
    instruction_table={
        "simd.fma": ("fma", 4, 1),
        "simd.add": ("fma", 4, 1),
        "simd.mul": ("fma", 4, 1),
        "simd.max": ("alu", 1, 1),
        "simd.exp": ("fma", 20, 8),   # polynomial expansion estimate
        "simd.rsqrt": ("fma", 4, 1),
        "simd.load": ("load", 5, 1),   # L1 hit latency
        "simd.store": ("store", 4, 1),
        "simd.broadcast": ("load", 5, 1),
        "scalar.addr": ("scalar", 1, 1),
        "scalar.loop": ("scalar", 1, 1),
        "scalar.jump": ("scalar", 1, 1),
    },
    issue_width=4,
    fast_mem_bytes=32 * 1024,  # L1D
    fast_mem_line=64,
    hbm_bandwidth=25e9,  # single-core sustainable DRAM stream
    clock_hz=_CLOCK,
    peak_flops_bf16=2 * 8 * 2 * _CLOCK,  # 2 FMA ports x 8 lanes x 2 flops
    peak_flops_f32=2 * 8 * 2 * _CLOCK,
    ici_bandwidth=0.0,
)

"""NVIDIA H100 SXM5 (80 GB) target description.

Data-sheet constants (NVIDIA H100 data sheet and Hopper architecture white
paper; dense rates, no sparsity, at the full 700 W power limit):

  * 132 SMs, 1.98 GHz boost clock; 4 warp schedulers per SM.
  * 227 KB (232,448 bytes) of shared memory usable by one block (opt-in
    above 48 KB as dynamic shared memory); 128 B lines.
  * HBM3: 3.35 TB/s.
  * Tensor cores: 989 TFLOP/s bf16; 67 TFLOP/s f32 outside them.
  * NVLink 4: 18 links of 25 GB/s per direction each.

The per-opcode instruction table waits for the slice that ports the cost
model; the flash block picker reads only the shared-memory budget, the clock
and the memory rate. This target is not registered anywhere.
"""
from repro_torch.hw.target import HardwareTarget

GPU_H100 = HardwareTarget(
    name="gpu_h100",
    kind="gpu",
    vreg_shape=(1, 32),  # one warp = 32 lanes
    mxu_shape=(16, 8),  # mma.sync m16n8k16 output tile
    num_cores=132,
    units=(),
    instruction_table={},
    issue_width=4,
    fast_mem_bytes=232_448,
    fast_mem_line=128,
    hbm_bandwidth=3.35e12,
    clock_hz=1.98e9,
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    ici_bandwidth=25e9,
)

"""Blocked matmul: the Hopper CUDA kernel's wrapper and its plain torch
version.

Replaces the TPU kernel ``_matmul_kernel`` of ``src/repro/kernels/matmul.py``
(``matmul_pallas``). The kernel runs persistent blocks that
walk the (bm, bn) output tiles, a producer warp that streams A and B tiles
with TMA through one or two shared-memory stages, and one or two consumer
warpgroups of 64 rows whose products are ``wgmma`` (bf16 or f16 in, f32
accumulation), written once in the input dtype at the end of each tile:
the 16-bit kernel of ``csrc/matmul.cuh``, built in bf16 into the
``matmul`` library and in f16 into ``matmul_f16`` (one nvcc each, in
parallel; ``SOURCE``). f32 tensors launch a second kernel, ``matmul_f32``:
SIMT, true f32 products by FFMA over the same (bm, bn, bk) tiles and one or
two TMA stages, built at the configurations whose stages fit shared memory
(``built``). The sources say what bounds each kernel on the H100 and what
the design does about it.

``matmul`` launches the kernel for CUDA tensors and runs ``matmul_plain`` for
CPU tensors, and for nothing else: on a CUDA tensor it launches or raises.
Both take their tiles from the caller's blocks by one rule
(``resolve_blocks``): each block is clamped to its dimension, as the
reference does, and the tile need not divide the shape. The grid covers
each dimension with ceil(dim / tile) tiles, the last one ragged: TMA
zero-fills the loads past the edge, so a ragged K slice adds nothing, and
the kernel stores no row or column past it. The result is the same C = A @ B
with f32 accumulation that the reference computes at any block that
divides.

This is a difference from the reference in the blocks accepted, not in
results: the reference asserts that each clamped block divides its
dimension, so (64, 64, 64) at M = 100 runs here and is refused there. A
Hopper kernel with 64-row wgmma tiles cannot offer the reference's 8-row
blocks, and a ragged tile is how it covers the reference's shapes (M = 8,
M = 96, K = 80). The launch refuses N or K that TMA cannot address: its
global row stride must be a multiple of 16 bytes, so N and K are multiples
of 8 in bf16 and f16 and of 4 in f32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.spaces import SM90_MATMUL_TILES, sm90_matmul_smem_bytes
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import build

BLOCKS = SM90_MATMUL_TILES  # bm / bn / bk values the kernel is built for
# shared memory of one stage: the A and B tiles, unpadded (the C tile stays
# in registers); the tuner's sm90 space prunes with the same function
smem_bytes = sm90_matmul_smem_bytes
# the kernels' entry points by input dtype (A and B alike), and the
# library (a csrc source) each is in
ENTRY = {torch.bfloat16: "matmul_bf16", torch.float16: "matmul_f16",
         torch.float32: "matmul_f32"}
SOURCE = {"matmul_bf16": "matmul", "matmul_f32": "matmul", "matmul_f16": "matmul_f16"}

# kernel launches in this process (the main-path witness), per input
# dtype: bf16, f32 and f16 apart; reset via ``ops.reset_launch_counts``
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_F16 = 0


def check_shapes(x: torch.Tensor, y: torch.Tensor) -> None:
    if (x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]
            or 0 in x.shape or 0 in y.shape):
        raise ValueError(f"expected A [M,K] and B [K,N]; got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")


def resolve_blocks(m: int, n: int, k: int, bm: int, bn: int,
                   bk: int) -> Tuple[int, int, int]:
    """The kernel's tiles for the caller's blocks at shape (m, n, k). Each
    block is clamped to its dimension (``min(bm, m)`` ...), as the
    reference does; then
    - a clamped size that is a built tile is the tile, ragged where it does
      not divide;
    - one that is not built but is the whole dimension (the block was at
      least that large) runs as the smallest built tile that covers the
      dimension, as one ragged tile, or where none covers it as the
      largest built tile, with a ragged last tile;
    - one that is not built and smaller than its dimension is refused with
      ``ValueError``."""
    tiles = []
    for name, dim, v in (("bm", m, bm), ("bn", n, bn), ("bk", k, bk)):
        v, built_sizes = min(v, dim), BLOCKS[name]
        if v not in built_sizes:
            if v < dim:
                raise ValueError(f"{name}={v} is not a built tile size {built_sizes}")
            v = next((t for t in built_sizes if t >= dim), built_sizes[-1])
        tiles.append(v)
    return tuple(tiles)


def built(bm: int, bn: int, bk: int, double_buffer: bool,
          dtype: torch.dtype) -> bool:
    """Whether a kernel is built for these tiles in ``dtype``: bf16 and f16
    at every tile of BLOCKS with one or two stages; f32 where its stages
    fit one H100 block's shared memory, the configurations the sm90 cost
    model scores without overflow."""
    if dtype not in ENTRY or any(v not in BLOCKS[name] for name, v in
                                 (("bm", bm), ("bn", bn), ("bk", bk))):
        return False
    size = torch.empty((), dtype=dtype).element_size()
    stages = 2 if double_buffer else 1
    return stages * smem_bytes(bm, bn, bk, size) <= GPU_H100.fast_mem_bytes


def matmul_plain(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int,
                 bk: int) -> torch.Tensor:
    """C = A @ B over the kernel's tiles (``resolve_blocks``), in torch: an
    f32 accumulator advances one bk slice of K at a time, the last one
    ragged where bk does not divide K (the kernel's K loop, whose
    zero-filled columns add nothing; its (bm, bn) output tiles are
    independent, so all of them advance together), and the result is cast
    to x's dtype once."""
    check_shapes(x, y)
    m, k = x.shape
    bm, bn, bk = resolve_blocks(m, y.shape[1], k, bm, bn, bk)
    return k_slices(x, y, bk)


def k_slices(x: torch.Tensor, y: torch.Tensor, bk: int) -> torch.Tensor:
    """The plain version's K loop at any ``bk`` (no built-tile check): an
    f32 accumulator advances one bk slice of K at a time, cast to x's dtype
    once."""
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, x.shape[1], bk):
        acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk].float()
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(entry: str = "matmul_bf16"):
    fn = getattr(build.load(SOURCE[entry]), entry)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# installing or removing a prebuilt library (a kernel bundle's) drops this
# handle, so the next launch runs the library now in place
build.register_load_clearer(_kernel.cache_clear)


def kernel_smem_bytes(bm: int, bn: int, bk: int, double_buffer: bool,
                      dtype: torch.dtype = torch.bfloat16) -> int:
    """The built library's own count of the shared memory the (bm, bn, bk)
    instantiation in ``dtype`` stages for A and B over its one or two
    stages; -1 where none is built. Loads (and if needed builds) the
    library: for checks on the card."""
    name = {torch.bfloat16: "matmul_smem_bytes", torch.float16: "matmul_f16_smem_bytes",
            torch.float32: "matmul_f32_smem_bytes"}[dtype]
    fn = getattr(build.load(SOURCE[ENTRY[dtype]]), name)
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(bm, bn, bk, int(double_buffer))


def _launch(x, y, bm: int, bn: int, bk: int,
            double_buffer: bool) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F32, LAUNCHES_F16
    m, k = x.shape
    n = y.shape[1]
    for name, t in (("A", x), ("B", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, A on {x.device}")
        if t.dtype not in ENTRY or t.dtype != x.dtype:
            raise TypeError(f"the matmul kernels take bfloat16, float16 or float32, "
                            f"A and B alike; {name} is {t.dtype}, A {x.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (n * x.element_size()) % 16 or (k * x.element_size()) % 16:
        raise ValueError(f"N={n} and K={k} must be multiples of "
                         f"{16 // x.element_size()} in {x.dtype}: TMA's global row "
                         f"stride is a multiple of 16 bytes")
    bm, bn, bk = resolve_blocks(m, n, k, bm, bn, bk)
    if not built(bm, bn, bk, double_buffer, x.dtype):
        raise ValueError(f"({bm}, {bn}, {bk}) with {2 if double_buffer else 1} "
                         f"stages is not built for {x.dtype}: its stages exceed "
                         f"one block's shared memory")
    fn = _kernel(ENTRY[x.dtype])
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                 bk, int(double_buffer),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: cudaError_t {err}")
    if x.dtype == torch.float32:
        LAUNCHES_F32 += 1
    elif x.dtype == torch.float16:
        LAUNCHES_F16 += 1
    else:
        LAUNCHES += 1
    return out


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int, bk: int,
           double_buffer: bool = True) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with f32 accumulation, output in A's dtype.
    CUDA tensors launch the Hopper kernel, CPU tensors run the plain
    version (which has no stages, so ``double_buffer`` does not reach it)."""
    check_shapes(x, y)
    if x.device.type == "cuda":
        return _launch(x, y, bm, bn, bk, double_buffer)
    if x.device.type == "cpu":
        return matmul_plain(x, y, bm, bn, bk)
    raise ValueError(f"no matmul for device {x.device}")

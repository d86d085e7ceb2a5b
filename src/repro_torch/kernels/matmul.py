"""Blocked matmul: the Hopper CUDA kernel's wrapper and its plain torch
version.

Replaces the TPU kernel ``_matmul_kernel`` of ``src/repro/kernels/matmul.py``
(``matmul_pallas``). The kernel is ``csrc/matmul.cu``: persistent blocks that
walk the (bm, bn) output tiles, a producer warp that streams A and B tiles
with TMA through one or two shared-memory stages, and one or two consumer
warpgroups of 64 rows whose products are ``wgmma`` (bf16 in, f32
accumulation), written once as bf16 at the end of each tile. Its source says
what bounds it on the H100 and what the design does about it.

``matmul`` launches the kernel for CUDA tensors and runs ``matmul_plain`` for
CPU tensors, and for nothing else: on a CUDA tensor it launches or raises.
Both clamp the blocks to the shape as the reference does, then refuse
(``ValueError``) blocks that do not divide the shape or were never built.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.spaces import SM90_MATMUL_TILES, sm90_matmul_smem_bytes
from repro_torch.kernels import build

BLOCKS = SM90_MATMUL_TILES  # bm / bn / bk values the kernel is built for
# shared memory of one stage: the A and B tiles, unpadded (the C tile stays
# in registers); the tuner's sm90 space prunes with the same function
smem_bytes = sm90_matmul_smem_bytes

# kernel launches in this process (the main-path witness); reset via
# ``ops.reset_launch_counts``
LAUNCHES = 0


def check_shapes(x: torch.Tensor, y: torch.Tensor) -> None:
    if (x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]
            or 0 in x.shape or 0 in y.shape):
        raise ValueError(f"expected A [M,K] and B [K,N]; got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")


def resolve_blocks(m: int, n: int, k: int, bm: int, bn: int,
                   bk: int) -> Tuple[int, int, int]:
    """The blocks clamped to the shape (``min(bm, m)`` ...), refused with
    ``ValueError`` when one does not divide its dimension or is not a
    built tile size."""
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shape ({m},{n},{k}) not divisible by blocks "
                         f"({bm},{bn},{bk})")
    for name, v in (("bm", bm), ("bn", bn), ("bk", bk)):
        if v not in BLOCKS[name]:
            raise ValueError(f"{name}={v} is not a built tile size "
                             f"{BLOCKS[name]}")
    return bm, bn, bk


def matmul_plain(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int,
                 bk: int) -> torch.Tensor:
    """C = A @ B over the kernel's blocks, in torch: an f32 accumulator
    advances one bk slice of K at a time (the kernel's K loop; its (bm, bn)
    output tiles are independent, so all of them advance together), and
    the result is cast to x's dtype once."""
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
def _kernel():
    fn = build.load("matmul").matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# installing or removing a prebuilt library (a kernel bundle's) drops this
# handle, so the next launch runs the library now in place
build.register_load_clearer(_kernel.cache_clear)


def kernel_smem_bytes(bm: int, bn: int, bk: int, double_buffer: bool) -> int:
    """The built library's own count of the shared memory the (bm, bn, bk)
    instantiation stages for A and B over its one or two stages; -1 where
    none is built. Loads (and if needed builds) the library: for checks on
    the card."""
    fn = build.load("matmul").matmul_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(bm, bn, bk, int(double_buffer))


def _launch(x, y, bm: int, bn: int, bk: int,
            double_buffer: bool) -> torch.Tensor:
    global LAUNCHES
    m, k = x.shape
    n = y.shape[1]
    for name, t in (("A", x), ("B", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, A on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the matmul kernel takes bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    bm, bn, bk = resolve_blocks(m, n, k, bm, bn, bk)
    fn = _kernel()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                 bk, int(double_buffer),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: cudaError_t {err}")
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

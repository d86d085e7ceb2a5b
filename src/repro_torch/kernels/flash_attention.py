"""Flash-attention forward: the Hopper CUDA kernel's wrapper and its plain
torch version.

Replaces the TPU kernel ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` (``flash_attention_pallas``). The
16-bit kernel is ``csrc/flash_attention.cuh``: one thread block per
(batch*q-head, q-tile), a producer warp that streams K/V tiles with TMA
through a ring of two shared-memory stages, and one or two consumer
warpgroups of 64 query rows whose products are ``wgmma`` (bf16 or f16 in,
f32 accumulation). Head dims 64, 80 and 128 have instantiations of their
own; any other head dim the kernels take (``supports_head_dim``: a multiple
of 8 from 8 to 256 in bf16 and f16, to 128 in f32) runs a generic build of
its padded width, 64, 128, 192 or 256 columns (``padded_head_dim``: 80 is
staged at 128 too), with the head dim passed at run time. f32 tensors
launch a second kernel, ``flash_attention_fwd_f32``: SIMT, true f32
products by FFMA, K/V tiles double-buffered with cp.async. Each dtype and
width is built at the blocks whose shared memory fits one block
(``built``). The instantiations are split over three libraries, one nvcc
each, built in parallel (``SOURCE``): bf16 up to 128 with f32, f16 up to
128, and both 16-bit types past 128. The sources say what bounds each
kernel on the H100 and what the design does about it.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors, and for nothing else: on a CUDA
tensor it launches or raises. The plain version walks the same q/k blocks
with the same tail handling, causal tile skip and GQA head map, so the CPU
tests exercise the kernel's tiling logic through it.

Training differentiates the forward through ``FlashAttention``, an autograd
function whose forward is the kernel (or, for CPU tensors, the plain
version) and whose backward is ``flash_attention_backward``: plain torch
from the softmax-attention formulas. The reference has no backward kernel
(its Pallas call has no VJP), so neither has the port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from repro_torch.core.zoo import (SM90_FLASH_BLOCKS, sm90_flash_smem_bytes,
                                  sm90_padded_head_dim)
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import build
from repro_torch.spans import span

_NEG_INF = -1e30
# 16-bit head dims with an instantiation of their own; every other head
# dim that ``supports_head_dim`` admits runs the generic build of its
# padded width (one of PADDED_WIDTHS)
HEAD_DIMS = (64, 80, 128)
PADDED_WIDTHS = (64, 128, 192, 256)
# the largest head dim each dtype's kernel takes: the f32 kernel's tiles
# (and its probability tile) fit one block's shared memory only up to 128
MAX_HEAD_DIM = {torch.bfloat16: 256, torch.float16: 256, torch.float32: 128}
# head dims past this run the wide builds (padded widths 192 and 256)
NARROW = 128
# the kernels' entry points by input dtype (q, k and v alike), at head dims
# up to NARROW and past it
ENTRY = {torch.bfloat16: "flash_attention_fwd_bf16",
         torch.float16: "flash_attention_fwd_f16",
         torch.float32: "flash_attention_fwd_f32"}
WIDE_ENTRY = {torch.bfloat16: "flash_attention_wide_fwd_bf16",
              torch.float16: "flash_attention_wide_fwd_f16"}
# the library (a csrc source) each entry point is in
SOURCE = {"flash_attention_fwd_bf16": "flash_attention",
          "flash_attention_fwd_f32": "flash_attention",
          "flash_attention_fwd_f16": "flash_attention_f16",
          "flash_attention_wide_fwd_bf16": "flash_attention_wide",
          "flash_attention_wide_fwd_f16": "flash_attention_wide"}
# block_q / block_k values the kernel is built for (the knobs of the
# ``flash`` family's ``sm90`` space)
BLOCKS = SM90_FLASH_BLOCKS

# kernel launches in this process (the main-path witness), per input
# dtype: bf16 (any head dim), f32 and f16 apart; reset via
# ``ops.reset_launch_counts``
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_F16 = 0

# the width the kernel stages a head dim at, and its dynamic shared memory
# at given blocks (the block picker's pruning): one definition, in core
padded_head_dim = sm90_padded_head_dim
smem_bytes = sm90_flash_smem_bytes


def supports_head_dim(d: int, dtype: torch.dtype) -> bool:
    """The head dims the kernels take in ``dtype``: a multiple of 8 (TMA's
    16-byte row stride in 16 bits) from 8 to 256 in bf16 and f16, to 128 in
    f32. Anything else raises without a launch."""
    return dtype in MAX_HEAD_DIM and 8 <= d <= MAX_HEAD_DIM[dtype] and d % 8 == 0


def entry_for(dtype: torch.dtype, d: int) -> str:
    """The entry point that runs ``dtype`` at head dim ``d``."""
    return WIDE_ENTRY[dtype] if d > NARROW else ENTRY[dtype]


def built(block_q: int, block_k: int, d: int, dtype: torch.dtype) -> bool:
    """Whether a kernel is built for head dim ``d`` at these blocks in
    ``dtype``: where its shared memory at d's padded width (in f32 the
    probability tile included) fits one H100 block, the count the block
    picker prunes with. In bf16 and f16 that is every block pair of BLOCKS
    up to 128 columns, three at 192 and two at 256."""
    if (not supports_head_dim(d, dtype) or block_q not in BLOCKS
            or block_k not in BLOCKS):
        return False
    size = torch.empty((), dtype=dtype).element_size()
    return smem_bytes(block_q, block_k, d, size) <= GPU_H100.fast_mem_bytes


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected q [B,Hq,S,D], k/v [B,Hkv,S,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if s < 1:
        raise ValueError("empty sequence")


def flash_attention_plain(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 64,
    block_k: int = 64,
) -> torch.Tensor:
    """Online-softmax attention over (block_q, block_k) tiles, in torch.

    Scores and the running max/sum/accumulator are f32; p is cast to v's
    dtype before the p·v product, which accumulates in f32. Tile slices stop
    at S (the kernel's tail mask: keys past S weigh nothing and query rows
    past S are never written), and with ``causal`` KV tiles wholly above
    the diagonal are skipped. It takes any head dim, the kernel's 64, 80
    (stablelm-3b's, which the kernel pads to 128) and 128 among them."""
    _check_shapes(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    h = torch.arange(b * hq, device=q.device)
    kv_rows = (h // hq) * hkv + (h % hq) // group
    qf = q.reshape(b * hq, s, d)
    kf = k.reshape(b * hkv, s, d)[kv_rows]
    vf = v.reshape(b * hkv, s, d)[kv_rows]
    out = torch.empty_like(qf)
    nk = -(-s // block_k)
    for q0 in range(0, s, block_q):
        q1 = min(q0 + block_q, s)
        qi = qf[:, q0:q1].float()
        m = torch.full((b * hq, q1 - q0, 1), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b * hq, q1 - q0, d), device=q.device)
        last = min(nk - 1, (q0 + block_q - 1) // block_k) if causal else nk - 1
        for kt in range(last + 1):
            k0, k1 = kt * block_k, min(kt * block_k + block_k, s)
            sc = (qi @ kf[:, k0:k1].float().transpose(1, 2)) * scale
            if causal:
                q_pos = torch.arange(q0, q1, device=q.device)[:, None]
                k_pos = torch.arange(k0, k1, device=q.device)[None, :]
                sc = sc.masked_fill(k_pos > q_pos, _NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ vf[:, k0:k1].float()
            m = m_new
        out[:, q0:q1] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(b, hq, s, d)


@functools.lru_cache(maxsize=None)
def _kernel(entry: str = "flash_attention_fwd_bf16"):
    fn = getattr(build.load(SOURCE[entry]), entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# The backward walks blocks of query rows, each against every key it sees, so
# one [B, Hq, rows, S] f32 block is the largest transient: rows are chosen to
# keep a block at most this many elements (128 MiB in f32).
BWD_BLOCK_ELEMS = 2**25


def flash_attention_backward(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    do: torch.Tensor,  # [B, Hq, S, D], the gradient of the output
    *,
    causal: bool = True,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of O = softmax(scale·QKᵀ, causal mask)·V, each in its
    input's dtype, computed in f32 from the formulas over blocks of query
    rows (as many as keep a block within ``BWD_BLOCK_ELEMS``):

        P = softmax(scale·QKᵀ);  dV = Pᵀ·dO;  dP = dO·Vᵀ;
        dS = P ∘ (dP − rowsum(dO ∘ O));  dQ = scale·dS·K;  dK = scale·dSᵀ·Q,

    with rowsum(dO ∘ O) taken as rowsum(P ∘ dP), the same sum with O = P·V
    exact in f32 (the reference's softmax VJP computes it so). From the
    forward's output instead, rounded to bf16, it errs by up to 0.11 of
    rms(dQ) at head dim 80, where dS cancels. Each block takes every key it
    can see (all of them, or with ``causal`` those up to its last row), so
    the row max and row sum of P are exact in one pass. dK and dV sum over
    each key head's group of query heads, the kernel's GQA head map."""
    _check_shapes(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    rows = max(1, min(s, BWD_BLOCK_ELEMS // (b * hq * s)))
    grouped = lambda t: t.reshape(b, hkv, g, s, d)
    qg, dog = grouped(q), grouped(do)
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s)
        n = r1 if causal else s  # the keys this block sees
        qi = qg[:, :, :, r0:r1].float()
        doi = dog[:, :, :, r0:r1].float()
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qi, kf[:, :, :n]) * scale
        if causal:
            above = (torch.arange(n, device=q.device)[None, :]
                     > torch.arange(r0, r1, device=q.device)[:, None])
            sc = sc.masked_fill(above, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        del sc
        dv[:, :, :n] += torch.einsum("bhgqk,bhgqd->bhkd", p, doi)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doi, vf[:, :, :n])
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del p, dp
        dq[:, :, :, r0:r1] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf[:, :, :n]) * scale
        dk[:, :, :n] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qi) * scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: ``apply(q, k, v, causal, scale,
    forward)`` returns ``forward(q, k, v)`` (the kernel, or a kernel
    bundle's entry, with ``causal`` and ``scale`` bound) and saves q, k and
    v; its backward is ``flash_attention_backward``, which recomputes P and
    so needs no output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float,
                forward: Callable[..., torch.Tensor]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return forward(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with span("flash.backward"):
            dq, dk, dv = flash_attention_backward(q, k, v, do, causal=ctx.causal,
                                                  scale=ctx.scale)
        return dq, dk, dv, None, None, None


# installing or removing a prebuilt library (a kernel bundle's) drops this
# handle, so the next launch runs the library now in place
build.register_load_clearer(_kernel.cache_clear)


def kernel_smem_bytes(block_q: int, block_k: int, d: int,
                      dtype: torch.dtype = torch.bfloat16) -> int:
    """The built library's own count of the shared memory it launches head
    dim d at (block_q, block_k) in ``dtype`` with; -1 where none is built.
    Loads (and if needed builds) the library that would run it: for checks
    on the card."""
    wide = d > NARROW and dtype in WIDE_ENTRY
    name = ("flash_attention_wide_smem_bytes" if wide else
            {torch.bfloat16: "flash_attention_smem_bytes",
             torch.float16: "flash_attention_f16_smem_bytes",
             torch.float32: "flash_attention_f32_smem_bytes"}[dtype])
    fn = getattr(build.load(SOURCE[WIDE_ENTRY[dtype] if wide else ENTRY[dtype]]), name)
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(d, block_q, block_k)


def _launch(q, k, v, causal: bool, scale: float, block_q: int,
            block_k: int) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F32, LAUNCHES_F16
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in ENTRY or t.dtype != q.dtype:
            raise TypeError(f"the flash kernels take bfloat16, float16 or float32, "
                            f"q, k and v alike; {name} is {t.dtype}, q {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not supports_head_dim(d, q.dtype):
        raise ValueError(f"the flash kernels take head dims that are multiples "
                         f"of 8 from 8 to {MAX_HEAD_DIM[q.dtype]} in {q.dtype}, "
                         f"not {d}")
    if not built(block_q, block_k, d, q.dtype):
        raise ValueError(f"blocks ({block_q}, {block_k}) are not built for "
                         f"{q.dtype} at head dim {d}: of {BLOCKS} x {BLOCKS}, "
                         f"those whose shared memory fits")
    if -(-s // block_q) > 65535:
        raise ValueError(f"{-(-s // block_q)} q-tiles exceed the grid's y extent")
    fn = _kernel(entry_for(q.dtype, d))
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, hq, hkv, s, d, block_q, block_k, scale, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    if q.dtype == torch.float32:
        LAUNCHES_F32 += 1
    elif q.dtype == torch.float16:
        LAUNCHES_F16 += 1
    else:
        LAUNCHES += 1
    return o


def flash_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 64,
    block_k: int = 64,
) -> torch.Tensor:
    """GQA flash-attention forward; out [B, Hq, S, D] in q's dtype. CUDA
    tensors launch the Hopper kernel, CPU tensors run the plain version."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    raise ValueError(f"no flash attention for device {q.device}")

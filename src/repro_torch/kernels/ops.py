"""Kernel entry points with statically picked schedules.

``matmul`` and ``attention`` dispatch on the tensors' device: a CUDA tensor
launches the hand-written Hopper kernel, a CPU tensor runs its plain torch
version. There is no switch that sends a CUDA tensor to the plain version.

Block sizes are static, device-free choices made once per shape and
memoised: ``matmul``'s come from the Tuna tuner
(``core.tuner.tuned_matmul_blocks``: the cost model ranks the Hopper matmul
space on the ``gpu_h100`` target), ``attention``'s from
``tuned_flash_blocks`` below. Both pickers consult the serving snapshot
(``use_schedule_cache(path)`` or ``$REPRO_TUNA_CACHE``) and then the warm
schedule DB (``use_schedule_db(path)`` or ``$REPRO_TUNA_DB``) first: on a
warm store a pick is a dict lookup, not a search.

Before any of that, a call without ``blocks`` asks the installed golden
kernel bundle (``use_kernel_bundle(path)`` or ``$REPRO_TUNA_BUNDLE``;
``repro_torch.tuna.golden``): a hit launches the bundled kernel at the
release's blocks, from the library the bundle carries, and never calls a
picker; the bundle's schedule index is also the pickers' first tier.
``kernel_build_counts`` counts the nvcc runs of this process: zero on a
start served from a bundle.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import op_registry, tuner
from repro_torch.core.tuner import tuned_matmul_blocks
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import build as _build
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import matmul as _matmul_mod
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                padded_head_dim, smem_bytes)


def use_schedule_db(path) -> None:
    """Point the block pickers at a warm schedule database (``None``: off)."""
    tuner.set_default_db(path)  # clears all registered block-pick memos


def use_schedule_cache(path) -> None:
    """Serve block picks from an immutable snapshot (``python -m
    repro_torch.tuna snapshot``), consulted before the DB, O(1) and
    lock-free (``None``: off)."""
    tuner.set_default_cache(path)  # clears all registered block-pick memos


def refresh_schedule_cache() -> bool:
    """Hot-swap the installed snapshot if it was republished (revalidated
    by the snapshot's content digest, not file stat). Clears the
    block-pick memos on a swap; True iff swapped."""
    return tuner.refresh_default_cache()


def use_kernel_bundle(path, device: str = "cuda") -> None:
    """Install a golden kernel bundle (``python -m repro_torch.tuna golden
    --bundle``; a versioned bundle or its ``latest`` pointer) for
    ``device``: its libraries are verified and installed before the first
    launch, and calls without ``blocks`` dispatch to its entries first
    (``None``: off, its libraries removed)."""
    tuner.set_default_bundle(path, device=device)  # clears the memos


def get_kernel_bundle():
    """The installed kernel bundle (or None)."""
    return tuner.get_default_bundle()


def kernel_build_counts() -> Dict[str, int]:
    """How many nvcc runs this process started, per kernel source."""
    return dict(_build.NVCC_RUNS)


def _bundle_executable(kernel: str, args, params: Optional[Dict] = None):
    """The installed bundle's kernel for this call, or None."""
    bundle = tuner.get_default_bundle()
    if bundle is None:
        return None
    return bundle.executable(kernel, args, params)


def launch_counts() -> Dict[str, int]:
    """How many times each hand-written kernel has launched in this process
    (the bf16 kernels under their family's name, the f32 and f16 ones with
    ``_f32`` and ``_f16``)."""
    return {"flash_attention": _flash_mod.LAUNCHES,
            "matmul": _matmul_mod.LAUNCHES,
            "flash_attention_f32": _flash_mod.LAUNCHES_F32,
            "matmul_f32": _matmul_mod.LAUNCHES_F32,
            "flash_attention_f16": _flash_mod.LAUNCHES_F16,
            "matmul_f16": _matmul_mod.LAUNCHES_F16}


def reset_launch_counts() -> None:
    for mod in (_flash_mod, _matmul_mod):
        mod.LAUNCHES = 0
        mod.LAUNCHES_F32 = 0
        mod.LAUNCHES_F16 = 0


def matmul(
    x: torch.Tensor,  # [M, K]
    y: torch.Tensor,  # [K, N]
    *,
    blocks: Optional[Tuple] = None,
) -> torch.Tensor:
    """Tuna-tuned blocked matmul. ``blocks`` is (bm, bn, bk) or (bm, bn,
    bk, double_buffer), the latter defaulting to two stages; without it the
    installed kernel bundle's entry for this call serves it, else the
    static tuner picks all four for this shape. The pick is keyed by the
    element width: f16 takes bf16's picks (``dtype_bytes=2``), as the two
    kernels share their tiles, shared memory and rate; a bundle entry is
    keyed by the dtype's name, so an f16 call never hits a bf16 entry."""
    _matmul_mod.check_shapes(x, y)
    if blocks is None:
        fn = _bundle_executable("matmul", (x, y))
        if fn is not None:
            return fn(x, y)
        blocks = tuned_matmul_blocks(x.shape[0], y.shape[1], x.shape[1],
                                     x.element_size())
    bm, bn, bk, *rest = blocks
    return _matmul_mod.matmul(x, y, bm=bm, bn=bn, bk=bk,
                              double_buffer=rest[0] if rest else True)


@functools.lru_cache(maxsize=256)
def tuned_flash_blocks(s: int, d: int, dtype_bytes: int = 2) -> Tuple[int, int]:
    """Static block_q/block_k choice for flash attention over the block
    sizes the CUDA kernel is built for (the ``flash`` family's ``sm90``
    space, whose signature keys the stored record by S, the real head dim
    and the dtype width).

    A stored record (snapshot, then DB) is returned as it is. On a miss
    the score is the reference pick's (``repro/kernels/ops.py``): per KV
    step a fixed matrix-unit cost plus the staged q/k/v bytes over the
    memory rate, times the number of (q-tile, kv-tile) steps, with ragged
    tiles counted whole, and the head dim at the width the kernel stages it
    (``padded_head_dim``). Candidates whose shared memory at this dtype
    width (``smem_bytes``: the q tile and two stages of k and v tiles, and
    in f32 the probability tile; the softmax statistics and the accumulator
    stay in registers) exceeds what one H100 block may use are pruned: in
    f32, and in 16 bits at widths 192 and 256, those are the blocks the
    kernel is not built for. f16 takes bf16's picks (``dtype_bytes=2``):
    the two share the kernel's tiles, shared memory and rate. The pick is
    written back to a writable default DB under strategy ``flash_grid``."""
    target = GPU_H100
    space = op_registry.make_space(
        "flash", {"s": s, "d": d, "dtype_bytes": dtype_bytes}, target.kind)
    sig = space.signature()
    rec = tuner.lookup_best(sig, target.name)  # snapshot cache, then DB
    if rec is not None:
        return rec.config["block_q"], rec.config["block_k"]
    dp = padded_head_dim(d)
    best, best_score, evals = None, float("inf"), 0
    for cfg in space.enumerate(None):
        bq, bk = cfg["block_q"], cfg["block_k"]
        evals += 1
        if smem_bytes(bq, bk, dp, dtype_bytes) > target.fast_mem_bytes:
            continue
        tiles = (bq // 128 or 1) * (bk // 128 or 1) * max(1, dp // 128)
        dma = (bq * dp + 2 * bk * dp) * dtype_bytes
        t = 2 * tiles * 20 / target.clock_hz + dma / target.hbm_bandwidth
        score = t * (-(-s // bq)) * (-(-s // bk))
        if score < best_score:
            best, best_score = (bq, bk), score
    if best is None:
        raise ValueError(f"no flash block fits shared memory at d={d}")
    db = tuner.get_default_db()
    if tuner._writable(db):
        from repro_torch.tuna.db import ScheduleRecord

        db.add(ScheduleRecord(
            op=sig, target=target.name,
            config={"block_q": best[0], "block_k": best[1]},
            score=best_score, evaluations=evals,
            meta={"strategy": "flash_grid"}))
    return best


# installing a store must invalidate this memo too (it lives here, not in
# core.tuner, which does not import the kernels)
tuner.register_memo_clearer(tuned_flash_blocks.cache_clear)


def attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    blocks: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Flash attention with statically picked blocks (the installed kernel
    bundle's entry for this call first, when ``blocks`` is not given),
    differentiable: both go through ``FlashAttention``, whose backward is
    ``flash_attention_backward``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "meta":
        # the dry run's meta tensors (``launch/dryrun.py``): the full-softmax
        # oracle, as the reference's host compile takes its jnp reference
        # path; its [S, S] scores are what the dry run's memory counts,
        # where the kernel keeps one tile
        return FlashAttention.apply(q, k, v, causal, scale, functools.partial(
            ref.attention, causal=causal, scale=scale))
    fn = None
    if blocks is None:
        fn = _bundle_executable("flash", (q, k, v), {"causal": causal, "scale": scale})
        if fn is None:
            blocks = tuned_flash_blocks(q.shape[-2], q.shape[-1], q.element_size())
    if fn is None:
        bq, bk = blocks
        fn = functools.partial(flash_attention, causal=causal, scale=scale,
                               block_q=bq, block_k=bk)
    return FlashAttention.apply(q, k, v, causal, scale, fn)

"""The port's kernels (plain blocked versions on the CPU, the CUDA kernels
on a card) held against the reference's Pallas kernels in interpret mode and
the reference oracles, on the same numpy-seeded inputs."""
import itertools
import re
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.core.tuner import tuned_matmul_blocks as jtuned_matmul_blocks
from repro.kernels.matmul import matmul_pallas
from repro.models.attention import chunked_attention as jchunked
from repro_torch.core.spaces import SM90_MATMUL_TILES
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels.flash_attention import (BLOCKS, HEAD_DIMS, PADDED_WIDTHS,
                                                 flash_attention, flash_attention_plain,
                                                 padded_head_dim, smem_bytes,
                                                 supports_head_dim)
from repro_torch.models.attention import chunked_attention

RNG = np.random.default_rng(42)
F32_TOL = dict(atol=3e-5, rtol=3e-4)  # f32: summation order only
BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # bf16 output rounding + bf16 p
# f16 output rounding (2^-10 relative, an ulp, on each side) + f16 p: the
# bf16 limit scaled by the 2^-3 between the two types' unit roundoffs
F16_TOL = dict(atol=5e-2 / 8, rtol=5e-2 / 8)


def _qkv(b, hq, hkv, s, d):
    return tuple(RNG.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def _torch(arrs, dtype=torch.float32, device="cpu"):
    return tuple(torch.from_numpy(a).to(device, dtype) for a in arrs)


def _np(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", [
    (1, 2, 2, 128, 64, 64, 64),     # MHA
    (2, 4, 2, 256, 64, 128, 64),    # GQA 2:1
    (1, 8, 1, 128, 32, 64, 128),    # MQA
    (2, 4, 4, 512, 128, 256, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_and_oracle(b, hq, hkv, s, d, bq, bk, causal):
    arrs = _qkv(b, hq, hkv, s, d)
    got = ops.attention(*_torch(arrs), causal=causal, blocks=(bq, bk))
    want_pallas = flash_attention_pallas(*map(jnp.asarray, arrs), causal=causal,
                                         block_q=bq, block_k=bk, interpret=True)
    want_ref = jref.attention(*map(jnp.asarray, arrs), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want_pallas), **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(want_ref), **F32_TOL)


@pytest.mark.parametrize("s", [1, 77, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_lengths(s, causal):
    """Ragged S with port blocks of 32 (tails masked, never written) against
    the Pallas kernel run with one S-sized block."""
    arrs = _qkv(1, 4, 2, s, 32)
    got = flash_attention_plain(*_torch(arrs), causal=causal, block_q=32,
                                block_k=32)
    want = flash_attention_pallas(*map(jnp.asarray, arrs), causal=causal,
                                  block_q=s, block_k=s, interpret=True)
    assert got.shape == (1, 4, s, 32)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("bq,bk", [(128, 128), (128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_8to1_at_built_blocks(bq, bk, causal):
    """yi-6b's head group (8 q-heads per kv-head) at D=128, through the
    blocks the Hopper kernel is built for: ops.attention and the plain
    version against the Pallas kernel (same blocks) and the oracle."""
    arrs = _qkv(1, 8, 1, 256, 128)
    got = ops.attention(*_torch(arrs), causal=causal, blocks=(bq, bk))
    plain = flash_attention_plain(*_torch(arrs), causal=causal, block_q=bq,
                                  block_k=bk)
    assert torch.equal(got, plain)
    want_pallas = flash_attention_pallas(*map(jnp.asarray, arrs), causal=causal,
                                         block_q=bq, block_k=bk, interpret=True)
    want_ref = jref.attention(*map(jnp.asarray, arrs), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want_pallas), **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(want_ref), **F32_TOL)


@pytest.mark.parametrize("s", [1, 77, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_lengths_at_built_blocks(s, causal):
    """Ragged S at blocks (64, 128): one partial q-tile and one partial KV
    tile, as the kernel's zero-filled TMA boxes see them, against the
    Pallas kernel run with one S-sized block and the oracle."""
    arrs = _qkv(1, 4, 2, s, 128)
    got = ops.attention(*_torch(arrs), causal=causal, blocks=(64, 128))
    assert got.shape == (1, 4, s, 128)
    want = flash_attention_pallas(*map(jnp.asarray, arrs), causal=causal,
                                  block_q=s, block_k=s, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(jref.attention(
        *map(jnp.asarray, arrs), causal=causal)), **F32_TOL)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_head_dim_80(s, causal):
    """stablelm-3b's head dim (MHA, which the kernel stages padded to 128
    columns) through ops.attention with the picked blocks: against the
    Pallas kernel at the same blocks and the oracle."""
    arrs = _qkv(1, 4, 4, s, 80)
    bq, bk = ops.tuned_flash_blocks(s, 80, 2)
    got = ops.attention(*_torch(arrs), causal=causal)
    assert got.shape == (1, 4, s, 80)
    want_pallas = flash_attention_pallas(*map(jnp.asarray, arrs), causal=causal,
                                         block_q=bq, block_k=bk, interpret=True)
    want_ref = jref.attention(*map(jnp.asarray, arrs), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want_pallas), **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(want_ref), **F32_TOL)


@pytest.mark.parametrize("s", [1, 77])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_head_dim_80_ragged(s, causal):
    """Ragged S at head dim 80 and blocks (64, 128) against the oracle."""
    arrs = _qkv(1, 4, 4, s, 80)
    got = flash_attention_plain(*_torch(arrs), causal=causal, block_q=64, block_k=128)
    np.testing.assert_allclose(_np(got), _np(jref.attention(
        *map(jnp.asarray, arrs), causal=causal)), **F32_TOL)


def test_flash_bf16():
    arrs = _qkv(1, 4, 2, 128, 64)
    got = ops.attention(*_torch(arrs, torch.bfloat16), causal=True,
                        blocks=(64, 64))
    assert got.dtype == torch.bfloat16
    jarrs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want = flash_attention_pallas(*jarrs, causal=True, block_q=64, block_k=64,
                                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(jref.attention(*jarrs)), **BF16_TOL)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("s", [128, 77])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f16_matches_pallas_and_oracle(d, s, causal):
    """f16 through ops.attention (the plain version on CPU tensors) at the
    blocks the picker gives (f16 takes bf16's: the same width), GQA 4/2,
    at head dims up to the wide builds' 256, against the Pallas kernel in
    f16 (interpreted; at S=77 with one S-sized block, as the ragged tests
    run it) and the oracle, within F16_TOL."""
    arrs = _qkv(1, 4, 2, s, d)
    bq, bk = ops.tuned_flash_blocks(s, d, 2)
    assert kflash.built(bq, bk, d, torch.float16)
    got = ops.attention(*_torch(arrs, torch.float16), causal=causal)
    assert got.dtype == torch.float16 and got.shape == (1, 4, s, d)
    assert torch.equal(got, flash_attention_plain(*_torch(arrs, torch.float16),
                                                  causal=causal, block_q=bq, block_k=bk))
    jarrs = [jnp.asarray(a, jnp.float16) for a in arrs]
    pq, pk = (bq, bk) if s % bq == 0 and s % bk == 0 else (s, s)
    want = flash_attention_pallas(*jarrs, causal=causal, block_q=pq, block_k=pk,
                                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F16_TOL)
    np.testing.assert_allclose(_np(got), _np(jref.attention(*jarrs, causal=causal)),
                               **F16_TOL)


@pytest.mark.parametrize("d", [136, 192, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_at_wide_head_dims(d, causal):
    """bf16 at head dims past 128 (the wide builds' padded widths 192 and
    256, and 136 and 200 staged inside them), GQA 4/2, through ops.attention
    at the picked blocks, against the Pallas kernel at the same blocks and
    the oracle, within BF16_TOL."""
    arrs = _qkv(1, 4, 2, 128, d)
    bq, bk = ops.tuned_flash_blocks(128, d, 2)
    assert kflash.built(bq, bk, d, torch.bfloat16) and padded_head_dim(d) in (192, 256)
    got = ops.attention(*_torch(arrs, torch.bfloat16), causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 128, d)
    jarrs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want = flash_attention_pallas(*jarrs, causal=causal, block_q=bq, block_k=bk,
                                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(jref.attention(*jarrs, causal=causal)),
                               **BF16_TOL)


@pytest.mark.parametrize("s", [1, 77, 513, 1024, 2047])
@pytest.mark.parametrize("d", [136, 192, 256])
def test_tuned_flash_blocks_at_wide_head_dims_are_built(s, d):
    """Every 16-bit pick past 128 columns is a block pair the wide builds
    have: the picker prunes by the same shared-memory count as ``built``."""
    bq, bk = ops.tuned_flash_blocks(s, d, 2)
    assert kflash.built(bq, bk, d, torch.bfloat16) and kflash.built(bq, bk, d, torch.float16)
    assert kflash.entry_for(torch.float16, d) == "flash_attention_wide_fwd_f16"
    assert kflash.SOURCE[kflash.entry_for(torch.bfloat16, d)] == "flash_attention_wide"


@pytest.mark.parametrize("causal", [True, False])
def test_torch_oracle_matches_reference_oracle(causal):
    arrs = _qkv(2, 4, 2, 64, 16)
    got = ref.attention(*_torch(arrs), causal=causal)
    want = jref.attention(*map(jnp.asarray, arrs), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("s,chunk", [(256, 64), (512, 128), (128, 128)])
def test_chunked_attention_matches_reference(s, chunk):
    arrs = _qkv(2, 4, 2, s, 32)
    got = chunked_attention(*_torch(arrs), causal=True, chunk=chunk)
    want = jchunked(*map(jnp.asarray, arrs), causal=True, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("s", [1, 16, 77, 513, 1024, 2047, 4095])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_tuned_flash_blocks_fit_the_kernel(s, d):
    bq, bk = ops.tuned_flash_blocks(s, d, 2)
    assert bq in BLOCKS and bk in BLOCKS
    assert smem_bytes(bq, bk, d) <= GPU_H100.fast_mem_bytes
    assert ops.tuned_flash_blocks(s, d, 2) is ops.tuned_flash_blocks(s, d, 2)


def test_tuned_flash_blocks_shrink_for_short_prompts():
    """A prompt no longer than the smallest block gets the smallest tiles:
    larger ones stage more bytes for the same single step."""
    assert ops.tuned_flash_blocks(1, 128, 2) == (64, 64)
    assert ops.tuned_flash_blocks(64, 128, 2) == (64, 64)
    assert ops.tuned_flash_blocks(77, 128, 2) == (128, 128)
    assert ops.tuned_flash_blocks(1024, 128, 2) == (128, 128)


@pytest.mark.parametrize("bq", BLOCKS)
@pytest.mark.parametrize("bk", BLOCKS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_built_flash_blocks_fit_shared_memory(bq, bk, d):
    """Every built instantiation fits the 232,448 bytes one H100 block may
    use, at one block per SM: Q, two K/V stages at the padded head dim
    (whole 64-column atoms: 80 is staged as 128), barriers, alignment."""
    dp = {64: 64, 80: 128, 128: 128}[d]
    assert padded_head_dim(d) == dp
    assert smem_bytes(bq, bk, d) <= 232_448 == GPU_H100.fast_mem_bytes
    assert smem_bytes(bq, bk, d) == 2 * dp * (bq + 4 * bk) + 128 + 1024


def _macro(src: str, name: str):
    body = re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S).group(1)
    return {tuple(map(int, t)) for t in re.findall(r"X\(([\d, ]+)\)", body)
            for t in [t.split(", ")]}


def test_flash_source_instantiates_exactly_the_built_blocks():
    """The (block_q, block_k, d) triples the 16-bit kernel
    (csrc/flash_attention.cuh) is built for up to 128 columns are BLOCKS x
    BLOCKS x HEAD_DIMS and, generically, BLOCKS x BLOCKS x (64, 128), in
    bf16 (flash_attention.cu) and f16 (flash_attention_f16.cu); its wide
    builds (flash_attention_wide.cu, both types) and the f32 builds
    (flash_attention.cu) are the (block_q, block_k, padded width) that
    ``built`` admits; the 16-bit products are wgmma, the f32 kernel's are
    not. Each entry point is in the library ``SOURCE`` names."""
    read = lambda name: (build.CSRC / name).read_text()
    head, src = read("flash_attention.cuh"), read("flash_attention.cu")
    f16, wide = read("flash_attention_f16.cu"), read("flash_attention_wide.cu")
    assert _macro(head, "FLASH_BUILT") == {
        (bq, bk, d) for bq in BLOCKS for bk in BLOCKS for d in HEAD_DIMS}
    assert HEAD_DIMS == (64, 80, 128) and PADDED_WIDTHS == (64, 128, 192, 256)
    assert _macro(head, "FLASH_ANY_D_BUILT") == {
        (bq, bk, dp) for bq in BLOCKS for bk in BLOCKS for dp in (64, 128)}
    for dtype in (torch.bfloat16, torch.float16):
        assert _macro(wide, "FLASH_WIDE_BUILT") == {
            (bq, bk, dp) for bq in BLOCKS for bk in BLOCKS for dp in (192, 256)
            if kflash.built(bq, bk, dp, dtype)}
    assert len(_macro(wide, "FLASH_WIDE_BUILT")) == 5
    assert _macro(src, "FLASH_F32_BUILT") == {
        (bq, bk, dp) for bq in BLOCKS for bk in BLOCKS for dp in PADDED_WIDTHS
        if kflash.built(bq, bk, dp, torch.float32)}
    assert "wgmma_ss" in head and "wgmma_rs" in head and "mma.sync" not in head
    # tiles and accumulator at the padded width, the store at the real one
    assert "int DP = (D + 63) / 64 * 64" in head and "wgmma_rs<T, C::kDP, 1>" in head
    assert "col >= dd" in head and "pack2<T>(" in head and "make_map<T>(" in head
    # each type's instantiations in its own library
    assert "narrow_fwd<bf16>" in src and "narrow_fwd<__half>" in f16
    assert "wide_fwd<__nv_bfloat16>" in wide and "wide_fwd<__half>" in wide
    for lib, text in (("flash_attention", src), ("flash_attention_f16", f16),
                      ("flash_attention_wide", wide)):
        entries = re.findall(r'extern "C" int (\w+)\(', text)
        assert [e for e in entries if "_fwd_" in e] == [
            e for e, source in kflash.SOURCE.items() if source == lib]
        assert any(e.endswith("smem_bytes") for e in entries)
    assert "flash_attention_f32_smem_bytes" in src
    # the f32 kernel stages with cp.async and multiplies by FFMA (fmaf),
    # with no tensor-core product
    f32 = src[src.index("f32, SIMT"):src.index("// ---------------------------"
                                                 "---------------------------------------- host")]
    assert "cp.async.cg.shared.global" in f32 and "fmaf(" in f32
    assert "wgmma" not in f32 and "tf32" not in f32


# the head dims of the generic bf16 builds and the f32 kernel (a multiple of
# 8 up to 128 that is not a built 64, 80 or 128), and two that are
OTHER_HEAD_DIMS = [8, 16, 24, 48, 96]


@pytest.mark.parametrize("d", OTHER_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_other_head_dims(d, dtype, causal):
    """ops.attention (the plain version on CPU tensors) at the blocks the
    picker gives for this dtype's width, against the Pallas kernel at the
    same blocks and the oracle: f32 to summation order (F32_TOL), bf16 to
    its output rounding and bf16 p (BF16_TOL)."""
    arrs = _qkv(1, 4, 2, 128, d)
    size = 4 if dtype == torch.float32 else 2
    bq, bk = ops.tuned_flash_blocks(128, d, size)
    got = ops.attention(*_torch(arrs, dtype), causal=causal)
    assert got.dtype == dtype and got.shape == (1, 4, 128, d)
    jarrs = [jnp.asarray(a, JDTYPE[dtype]) for a in arrs]
    want_pallas = flash_attention_pallas(*jarrs, causal=causal, block_q=bq, block_k=bk,
                                         interpret=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want_pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.attention(*jarrs, causal=causal)), **tol)


@pytest.mark.parametrize("d,ok", [(0, False), (4, False), (8, True), (12, False),
                                  (16, True), (20, False), (120, True), (128, True),
                                  (132, False), (136, False), (192, False),
                                  (200, False), (256, False), (260, False),
                                  (264, False)])
def test_supports_head_dim_at_the_rules_edges(d, ok):
    """f32: a multiple of 8 (TMA's 16-byte row stride) from 8 to 128
    (``ok``); bf16 and f16: the same and the multiples of 8 from 136 to 256
    (the wide builds, padded to 192 or 256 columns)."""
    wide = 128 < d <= 256 and d % 8 == 0
    assert supports_head_dim(d, torch.float32) is ok
    assert kflash.built(64, 64, d, torch.float32) is ok
    for dtype in (torch.bfloat16, torch.float16):
        assert supports_head_dim(d, dtype) is (ok or wide)
        assert kflash.built(64, 64, d, dtype) is (ok or wide)
    assert not supports_head_dim(d, torch.float64)


@pytest.mark.parametrize("bq", BLOCKS)
@pytest.mark.parametrize("bk", BLOCKS)
@pytest.mark.parametrize("dp", PADDED_WIDTHS)
def test_f32_flash_smem_is_the_kernels_count(bq, bk, dp):
    """The f32 kernel stages Q [bq][dp], two stages of K and V [bk][dp] and
    P [bq][bk], all f32, with no barrier and no slack; it is built exactly
    where that fits one H100 block, up to 128 columns. The 16-bit kernels
    are built where their own count fits: every pair up to 128 columns,
    three at 192, two at 256."""
    hand = 4 * (bq * dp + 2 * 2 * bk * dp + bq * bk)
    assert smem_bytes(bq, bk, dp, 4) == hand == smem_bytes(bq, bk, dp - 8, 4)
    assert kflash.built(bq, bk, dp, torch.float32) is (
        hand <= GPU_H100.fast_mem_bytes and dp <= 128)
    # the 16-bit kernels: built wherever their own count fits
    fits = smem_bytes(bq, bk, dp, 2) <= GPU_H100.fast_mem_bytes
    assert kflash.built(bq, bk, dp, torch.bfloat16) is fits
    assert kflash.built(bq, bk, dp, torch.float16) is fits
    wide = {192: {(64, 64), (64, 128), (128, 64)}, 256: {(64, 64), (128, 64)}}
    assert fits is (dp <= 128 or (bq, bk) in wide[dp])
    assert smem_bytes(bq, bk, dp, 2) == smem_bytes(bq, bk, dp)


@pytest.mark.parametrize("s", [1, 12, 64, 77, 513, 1024, 2047])
@pytest.mark.parametrize("d", [8, 16, 48, 64, 80, 96, 128])
def test_tuned_flash_blocks_fit_the_f32_kernel(s, d):
    """Every f32 pick is a block pair the f32 kernel is built for."""
    bq, bk = ops.tuned_flash_blocks(s, d, 4)
    assert kflash.built(bq, bk, d, torch.float32)
    assert smem_bytes(bq, bk, d, 4) <= GPU_H100.fast_mem_bytes


@pytest.mark.parametrize("dtype,d,blocks,err", [
    (torch.float64, 64, (64, 64), TypeError),     # f64: no kernel
    (torch.float32, 136, (64, 64), ValueError),   # f32 at D > 128
    (torch.bfloat16, 20, (64, 64), ValueError),   # D % 8 != 0
    (torch.float32, 128, (128, 128), ValueError),  # f32 blocks that do not fit
    (torch.bfloat16, 64, (32, 64), ValueError),   # blocks never built
    (torch.bfloat16, 264, (64, 64), ValueError),  # D > 256
    (torch.float16, 264, (64, 64), ValueError),
    (torch.float16, 20, (64, 64), ValueError),
    (torch.float16, 256, (64, 128), ValueError),  # 16-bit blocks that do not fit
    (torch.bfloat16, 192, (128, 128), ValueError),
])
def test_flash_launch_refuses_what_no_kernel_is_built_for(monkeypatch, dtype, d,
                                                          blocks, err):
    """The wrapper's launch refuses before it loads a library."""
    monkeypatch.setattr(kflash, "_kernel", lambda entry: pytest.fail("loaded"))
    q = torch.zeros((1, 2, 8, d), dtype=dtype)
    k = torch.zeros((1, 1, 8, d), dtype=dtype)
    with pytest.raises(err):
        kflash._launch(q, k, k, True, 1.0, *blocks)


def test_wrapper_has_no_fallback_off_cpu():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    q = torch.empty((1, 2, 8, 64), device="meta")
    k = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, k, k)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros((1, 3, 8, 64))
    k = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)


def test_launch_counter_only_counts_kernel_launches():
    ops.reset_launch_counts()
    arrs = _torch(_qkv(1, 2, 1, 8, 64))
    ops.attention(*arrs)  # CPU: the plain versions, not launches
    ops.matmul(torch.ones((64, 64)), torch.ones((64, 64)))
    ops.attention(*(t.half() for t in arrs))
    ops.matmul(torch.ones((64, 64), dtype=torch.float16),
               torch.ones((64, 64), dtype=torch.float16))
    assert ops.launch_counts() == {"flash_attention": 0, "matmul": 0,
                                   "flash_attention_f32": 0, "matmul_f32": 0,
                                   "flash_attention_f16": 0, "matmul_f16": 0}


def test_kernel_library_is_keyed_by_source_digest():
    """Each source builds into its own library under the build directory,
    named by a digest of the sources and flags, so an edit rebuilds."""
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    assert path == build.library_path("flash_attention")
    assert set(build.SOURCES) == {f.stem for f in build.CSRC.glob("*.cu")}


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """Where there is no CUDA toolkit the build says so; nothing is
    written and nothing falls back."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "never-made")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not build.BUILD_DIR.exists()


def test_kernel_builds_run_in_parallel(tmp_path, monkeypatch):
    """Every source that needs building gets its own nvcc, all started
    together; a second build finds the libraries and compiles nothing."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "t0 = time.time(); time.sleep(1.0)\n"
        "open(out, 'w').write(f'{t0} {time.time()}')\n"
        "print('ptxas info    : Used 32 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    secs = build.build()
    assert set(secs) == set(build.SOURCES) and all(s > 0 for s in secs.values())
    spans = [tuple(map(float, build.library_path(n).read_text().split()))
             for n in build.SOURCES]
    assert max(s for s, _ in spans) < min(e for _, e in spans)  # overlapped
    assert "registers" in build.log_path("matmul").read_text()
    assert build.build() == {n: 0.0 for n in build.SOURCES}


# --------------------------------------------------------------------------
# matmul
# --------------------------------------------------------------------------

# the reference's TestMatmulKernel tolerances: TOL * sqrt(k) atol, TOL rtol
MATMUL_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-1}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}
# f16: the reference's grid has none; both sides sum exact f16 products in
# f32 and round once to f16 (an ulp, 2^-10 relative), so the bf16 limit
# scaled by the 2^-3 between the unit roundoffs
MATMUL_F16_TOL = 2e-1 / 8


def _xy(m, n, k):
    return (RNG.standard_normal((m, k)).astype(np.float32),
            RNG.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,n,k,bm,bn,bk", [
    (128, 128, 128, 64, 64, 64),
    (256, 128, 512, 128, 128, 128),
    (64, 256, 128, 64, 128, 128),   # blocks clamp to shape
    (384, 256, 256, 128, 256, 128),  # non-pow2 M
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_matches_pallas_and_oracle(m, n, k, bm, bn, bk, dtype):
    """The reference's TestMatmulKernel grid, through ops.matmul (the plain
    version on CPU tensors) and matmul_plain."""
    x, y = _xy(m, n, k)
    got = ops.matmul(*_torch((x, y), dtype), blocks=(bm, bn, bk))
    assert got.dtype == dtype and got.shape == (m, n)
    plain = kmatmul.matmul_plain(*_torch((x, y), dtype), bm, bn, bk)
    assert torch.equal(got, plain)
    jx, jy = (jnp.asarray(a, JDTYPE[dtype]) for a in (x, y))
    want_pallas = matmul_pallas(jx, jy, bm=bm, bn=bn, bk=bk, interpret=True)
    tol = dict(atol=MATMUL_TOL[dtype] * np.sqrt(k), rtol=MATMUL_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.matmul(jx, jy)), **tol)
    np.testing.assert_allclose(_np(ref.matmul(*_torch((x, y), dtype))),
                               _np(jref.matmul(jx, jy)), **tol)


@pytest.mark.parametrize("shape,blocks", [
    ((128, 256, 128), (64, 128, 64)),    # tiles that divide
    ((256, 128, 512), None),             # the tuner's pick
    ((96, 256, 80), (64, 64, 64)),       # ragged M and K
    ((8, 4096, 256), None),              # decode-sized M
])
def test_matmul_f16_matches_pallas_and_oracle(shape, blocks):
    """f16 through ops.matmul (the plain version on CPU tensors), with
    explicit tiles and with the tuner's pick (f16 takes bf16's: the same
    width), against the Pallas kernel in f16 (interpreted, at blocks that
    divide, or at the reference's own pick where the port's tile is
    ragged) and the oracle, within MATMUL_F16_TOL * sqrt(K) + MATMUL_F16_TOL
    * |want|."""
    m, n, k = shape
    x, y = _xy(m, n, k)
    tx, ty = _torch((x, y), torch.float16)
    got = ops.matmul(tx, ty, blocks=blocks)
    assert got.dtype == torch.float16 and got.shape == (m, n)
    used = blocks or ops.tuned_matmul_blocks(m, n, k, 2)
    assert kmatmul.built(*kmatmul.resolve_blocks(m, n, k, *used[:3]),
                         (used[3] if len(used) > 3 else True), torch.float16)
    assert torch.equal(got, kmatmul.matmul_plain(tx, ty, *used[:3]))
    jx, jy = (jnp.asarray(a, jnp.float16) for a in (x, y))
    jb = (blocks if blocks and all(dim % b == 0 for dim, b in zip((m, n, k), blocks))
          else jtuned_matmul_blocks(m, n, k, 2))
    want = matmul_pallas(jx, jy, bm=jb[0], bn=jb[1], bk=jb[2], interpret=True)
    tol = dict(atol=MATMUL_F16_TOL * np.sqrt(k), rtol=MATMUL_F16_TOL)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.matmul(jx, jy)), **tol)


def test_matmul_f32_is_exact_to_summation_order():
    """In f32 the plain version is the reference's product up to summation
    order: far inside the reference's tolerance."""
    x, y = _xy(256, 128, 512)
    got = ops.matmul(*_torch((x, y)), blocks=(128, 64, 64))
    want = matmul_pallas(jnp.asarray(x), jnp.asarray(y), bm=128, bn=64, bk=64,
                         interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=1e-5)


def test_matmul_picks_tuned_blocks_when_none_given():
    x, y = _xy(256, 384, 512)
    blocks = ops.tuned_matmul_blocks(256, 384, 512, 4)
    got = ops.matmul(*_torch((x, y)))
    assert torch.equal(got, kmatmul.matmul_plain(*_torch((x, y)), *blocks[:3]))
    np.testing.assert_allclose(_np(got), x @ y, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("m,n,k,blocks", [
    (128, 128, 128, (16, 64, 64)),   # bm never built, smaller than M
    (128, 128, 128, (64, 64, 32)),   # bk never built, smaller than K
    (100, 128, 128, (64, 32, 64)),   # bn never built, smaller than N
])
def test_matmul_refuses_unbuilt_or_indivisible_blocks(m, n, k, blocks):
    """A block that clamps to a size never built and smaller than its
    dimension is refused; a ragged tile is not (the next test)."""
    x, y = _torch(_xy(m, n, k))
    with pytest.raises(ValueError):
        ops.matmul(x, y, blocks=blocks)
    with pytest.raises(ValueError):
        kmatmul.matmul_plain(x, y, *blocks)


@pytest.mark.parametrize("m,n,k,blocks,tiles,ref_refuses", [
    (100, 128, 128, (64, 64, 64), (64, 64, 64), True),   # indivisible (the reference's case)
    (128, 128, 96, (64, 64, 64), (64, 64, 64), True),    # K not divisible by bk
    # bm clamps to 48, which the reference runs and the port never built
    (48, 128, 128, (64, 64, 64), (64, 64, 64), False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_runs_ragged_blocks_the_reference_refuses(m, n, k, blocks, tiles,
                                                         ref_refuses, dtype):
    """Blocks that do not divide the shape, or clamp to a size never built,
    run with a ragged last tile where the port refused them before: the
    reference's Pallas kernel refuses the first two (their clamped blocks
    do not divide), and the port's result is the product the reference
    computes at a block that divides (the whole shape), within the
    reference's tolerance."""
    x, y = _xy(m, n, k)
    assert kmatmul.resolve_blocks(m, n, k, *blocks) == tiles
    got = ops.matmul(*_torch((x, y), dtype), blocks=blocks)
    assert got.shape == (m, n) and got.dtype == dtype
    assert torch.equal(got, kmatmul.matmul_plain(*_torch((x, y), dtype), *blocks))
    jx, jy = (jnp.asarray(a, JDTYPE[dtype]) for a in (x, y))
    if ref_refuses:
        with pytest.raises(AssertionError, match="not divisible"):
            matmul_pallas(jx, jy, bm=blocks[0], bn=blocks[1], bk=blocks[2], interpret=True)
    tol = dict(atol=MATMUL_TOL[dtype] * np.sqrt(k), rtol=MATMUL_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(matmul_pallas(jx, jy, bm=m, bn=n, bk=k,
                                                           interpret=True)), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.matmul(jx, jy)), **tol)


# the shapes at which no built tile divides a dimension, (M, N, K): decode-
# sized M, M = 96, K = 80 and N = 8; the reference's Pallas kernel runs each
# at its own pick
RAGGED_SHAPES = [(8, 4096, 4096), (32, 256, 256), (1, 256, 256), (96, 256, 256),
                 (256, 256, 80), (64, 8, 64)]


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("blocks", [None, (64, 64, 64), (128, 256, 128, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_ragged_tiles_match_pallas_and_oracle(shape, blocks, dtype):
    """ops.matmul at the shapes no built tile divides, with the tuner's pick
    and with explicit blocks: the plain version bit for bit, then the
    reference's Pallas kernel (interpreted, at the reference's own pick)
    and its oracle within the reference's tolerance."""
    m, n, k = shape
    x, y = _xy(m, n, k)
    tx, ty = _torch((x, y), dtype)
    got = ops.matmul(tx, ty, blocks=blocks)
    assert got.shape == (m, n) and got.dtype == dtype
    used = blocks or ops.tuned_matmul_blocks(m, n, k, tx.element_size())
    assert torch.equal(got, kmatmul.matmul_plain(tx, ty, *used[:3]))
    jx, jy = (jnp.asarray(a, JDTYPE[dtype]) for a in (x, y))
    jbm, jbn, jbk = jtuned_matmul_blocks(m, n, k, tx.element_size())
    want_pallas = matmul_pallas(jx, jy, bm=jbm, bn=jbn, bk=jbk, interpret=True)
    tol = dict(atol=MATMUL_TOL[dtype] * np.sqrt(k), rtol=MATMUL_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.matmul(jx, jy)), **tol)


@pytest.mark.parametrize("m,n,k,blocks,tiles", [
    (48, 128, 128, (64, 64, 64), (64, 64, 64)),      # one ragged tile of 64
    (200, 128, 128, (512, 64, 64), (128, 64, 64)),   # no built tile covers 200
    (100, 128, 128, (128, 64, 64), (128, 64, 64)),   # 128 is built: one ragged tile
    (64, 8, 64, (64, 256, 64), (64, 64, 64)),        # N = 8: the smallest cover
    (256, 256, 80, (64, 64, 128), (64, 64, 128)),    # bk 128 covers K = 80
    (256, 256, 80, (64, 64, 64), (64, 64, 64)),      # a ragged last K slice of 16
    (128, 128, 128, (64, 64, 256), (64, 64, 128)),   # clamps to a built size
])
def test_matmul_resolve_blocks_rule(m, n, k, blocks, tiles):
    """The tiles a caller's blocks run as: clamped to the shape, a built
    size as it is, an unbuilt whole dimension as the smallest built tile
    that covers it (the largest where none does)."""
    assert kmatmul.resolve_blocks(m, n, k, *blocks) == tiles


def test_matmul_blocks_clamp_to_the_shape():
    """A block larger than its dimension clamps to it, as in the reference:
    bk 256 -> 128 here, a built size, so it runs."""
    assert kmatmul.resolve_blocks(128, 128, 128, 64, 64, 256) == (64, 64, 128)
    x, y = _xy(128, 128, 128)
    got = ops.matmul(*_torch((x, y)), blocks=(64, 64, 256))
    np.testing.assert_allclose(_np(got), x @ y, atol=1e-3, rtol=1e-4)


def test_matmul_refuses_bad_shapes_and_devices():
    with pytest.raises(ValueError):
        ops.matmul(torch.zeros((64, 32)), torch.zeros((64, 32)))
    with pytest.raises(ValueError):
        kmatmul.matmul(torch.empty((64, 64), device="meta"),
                       torch.empty((64, 64), device="meta"), bm=64, bn=64, bk=64)


def test_matmul_source_instantiates_exactly_the_built_tiles():
    """The (bm, bn, bk) tiles the 16-bit kernel (csrc/matmul.cuh)
    instantiates (each with one and two stages), in bf16 (matmul.cu) and in
    f16 (matmul_f16.cu), are exactly the sm90 knob values the tuner ranks
    (core/spaces.SM90_MATMUL_TILES): bm {64, 128}, bn {64, 128, 256}, bk
    {64, 128}. Its products are wgmma and its loads TMA."""
    head = (build.CSRC / "matmul.cuh").read_text()
    f16 = (build.CSRC / "matmul_f16.cu").read_text()
    src = (build.CSRC / "matmul.cu").read_text()
    macro = re.search(r"#define MM_BUILT\(X\)(.*?)\n\n", head, re.S).group(1)
    built = [tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", macro)]
    assert SM90_MATMUL_TILES == kmatmul.BLOCKS == {
        "bm": (64, 128), "bn": (64, 128, 256), "bk": (64, 128)}
    assert sorted(built) == sorted(itertools.product(*SM90_MATMUL_TILES.values()))
    assert "launch<T, BM_, BN_, BK_, 2>" in head and "launch<T, BM_, BN_, BK_, 1>" in head
    assert "wgmma_ss<T, BN, 1>" in head and "tma_load_3d" in head
    assert "mm16<__nv_bfloat16>" in src and "mm16<__half>" in f16
    for text in (head, src, f16):
        assert "mma.sync" not in text and "cp.async" not in text
        assert not re.search(r"gemm|gemv|xmma|nvjet", text, re.IGNORECASE)
    for entry, lib in kmatmul.SOURCE.items():
        text = {"matmul": src, "matmul_f16": f16}[lib]
        assert f'extern "C" int {entry}(' in text
        assert f'extern "C" int {entry.replace("_bf16", "")}_smem_bytes(' in text
    # the f32 kernel: every (bm, bn, bk, stages) whose stages fit, FFMA
    # products over TMA-staged tiles, its own entry points
    assert _macro(src, "MM_F32_BUILT") == {
        (bm, bn, bk, 2 if db else 1)
        for bm, bn, bk in itertools.product(*SM90_MATMUL_TILES.values())
        for db in (False, True) if kmatmul.built(bm, bn, bk, db, torch.float32)}
    assert len(_macro(src, "MM_F32_BUILT")) == 21
    assert 'extern "C" int matmul_f32(' in src
    assert 'extern "C" int matmul_f32_smem_bytes(' in src
    f32 = src[src.index("struct CfgF32"):src.index("// ---------------------------"
                                                     "---------------------------------------- host")]
    assert "fmaf(" in f32 and "tma_load_3d" in f32 and "wgmma" not in f32
    assert "make_map_f32(&ta, a, 1, m, k, BM, BK)" in src


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 512), (64, 256, 128),
                                   (384, 256, 256), (256, 256, 256), (512, 512, 512),
                                   (2048, 4096, 4096), (2048, 512, 4096),
                                   (2048, 11008, 4096), (2048, 4096, 11008),
                                   (2048, 64000, 4096)])
def test_tuned_matmul_blocks_at_f32_are_built(shape):
    """The tuner's f32 pick (the sm90 space at dtype_bytes=4) is a
    configuration the f32 kernel is built for, at the reference's grid, the
    dense presets and yi-6b's shapes."""
    m, n, k = shape
    bm, bn, bk, db = ops.tuned_matmul_blocks(m, n, k, 4)
    assert kmatmul.built(*kmatmul.resolve_blocks(m, n, k, bm, bn, bk), db, torch.float32)


def test_f32_matmul_is_built_where_the_cost_model_sees_no_overflow():
    """The f32 kernel's 21 configurations are the sm90 ones whose stages
    fit shared memory by the cost model's own count (its ``vmem_overflow``
    is zero), and the library stages what that count says."""
    from repro_torch.core.spaces import MatmulSpace

    space = MatmulSpace(2048, 2048, 2048, 4, target_kind="sm90")
    for cfg in space.enumerate(None):
        _, meta = space.instantiate(cfg)
        stages = 2 if cfg["double_buffer"] else 1
        fits = meta.vmem_tile_bytes * stages <= GPU_H100.fast_mem_bytes
        assert kmatmul.built(cfg["bm"], cfg["bn"], cfg["bk"], cfg["double_buffer"],
                             torch.float32) is fits
        assert kmatmul.built(cfg["bm"], cfg["bn"], cfg["bk"], cfg["double_buffer"],
                             torch.bfloat16)


@pytest.mark.parametrize("dtype,n,k,blocks,err", [
    (torch.float64, 128, 128, (64, 64, 64, True), TypeError),     # f64: no kernel
    (torch.float32, 128, 128, (128, 128, 128, True), ValueError),  # two stages do not fit
    (torch.float32, 256, 128, (128, 256, 128, True), ValueError),
    (torch.bfloat16, 128, 128, (64, 64, 32, True), ValueError),   # bk never built
    # TMA's global row stride is a multiple of 16 bytes: N and K multiples
    # of 8 in bf16, of 4 in f32
    (torch.bfloat16, 128, 100, (64, 64, 64, True), ValueError),
    (torch.bfloat16, 100, 128, (64, 64, 64, True), ValueError),
    (torch.float32, 98, 128, (64, 64, 64, True), ValueError),
    (torch.float16, 100, 128, (64, 64, 64, True), ValueError),
    (torch.float16, 128, 100, (64, 64, 64, True), ValueError),
])
def test_matmul_launch_refuses_what_no_kernel_is_built_for(monkeypatch, dtype, n, k,
                                                           blocks, err):
    """The wrapper's launch refuses before it loads a library; the f32 one
    at (128, 128, 128) launches with one stage."""
    monkeypatch.setattr(kmatmul, "_kernel", lambda entry: pytest.fail("loaded"))
    x, y = torch.zeros((128, k), dtype=dtype), torch.zeros((k, n), dtype=dtype)
    with pytest.raises(err):
        kmatmul._launch(x, y, *blocks)
    assert kmatmul.built(128, 128, 128, False, torch.float32)

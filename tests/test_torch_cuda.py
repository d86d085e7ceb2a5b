"""The port's CUDA kernels held against their plain torch versions on the card.

Imports no jax, so it runs where only the port is installed:
    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
Without a card every test here skips.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_plain

# |kernel - plain| <= RTOL * |plain| + ATOL_RMS * rms(plain): one bf16 ulp of
# the output, plus a floor for outputs near zero (as in chip_smoke.py)
RTOL, ATOL_RMS = 2**-7, 0.02
# f32, the reference's own limits (tests/test_kernels.py): flash |kernel -
# plain| <= F32_ATOL + F32_RTOL * |plain|; matmul MM_F32_TOL * (sqrt(K) +
# |plain|). Both sum exact f32 products in another order.
F32_ATOL, F32_RTOL = 3e-5, 3e-4
MM_F32_TOL = 2e-4
# the bf16 head dims of the generic builds (one or two 64-column atoms)
OTHER_HEAD_DIMS = (16, 32, 48, 96)
FLASH_BLOCKS = [(64, 64), (64, 128), (128, 64), (128, 128)]
# f16 flash, per element (as in chip_smoke.py): |kernel - plain| <=
# F16_RTOL*|plain| + F16_FLIP*softmax(scale q k^T)|v|: two f16 ulps of the
# output, and one f16 ulp (2^-10 relative) of every p times |v|, the most
# the f16 cast of p moves an output where ex2.approx and torch.exp put a p
# on either side of a rounding point
F16_RTOL, F16_FLIP = 2**-9, 2**-10
# head dims past 128: the wide builds' padded widths 192 and 256, and two
# head dims staged inside them
WIDE_HEAD_DIMS = (136, 192, 200, 256)


def _within(got, want, rtol, atol_rms):
    """(elements outside rtol*|want| + atol_rms*rms(want), worst share)."""
    got, want = got.float(), want.float()
    limit = rtol * want.abs() + atol_rms * want.pow(2).mean().sqrt()
    ratio = (got - want).abs() / limit
    return int((ratio > 1).sum()), float(ratio.max())


def _f16_within(got, want, q, k, v, causal):
    """(elements outside the f16 flash limit, worst share)."""
    from repro_torch.kernels import ref

    flips = F16_FLIP * ref.attention(q.float(), k.float(), v.float().abs(), causal=causal)
    ratio = (got.float() - want.float()).abs() / (F16_RTOL * want.float().abs() + flips)
    return int((ratio > 1).sum()), float(ratio.max())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, hq, hkv, s, d, device):
    rng = np.random.default_rng(s * 1000 + d)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(device, torch.bfloat16)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 513, 1024, 2047])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("blocks", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain(card, s, d, blocks, causal):
    q, k, v = _qkv(2, 8, 2, s, d, card)
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=causal, blocks=blocks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, block_q=blocks[0],
                                 block_k=blocks[1])
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    atol = ATOL_RMS * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 513, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_head_dim_80_mha(card, s, causal):
    """stablelm-3b's attention shape (32 heads of 80, MHA) with the picked
    blocks: the padded second column atom carries columns 64-79."""
    q, k, v = _qkv(1, 32, 32, s, 80, card)
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    bq, bk = ops.tuned_flash_blocks(s, 80, 2)
    want = flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert got.shape == (1, 32, s, 80)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    atol = ATOL_RMS * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    assert np.abs(got[..., 64:]).max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 513, 1024])
@pytest.mark.parametrize("d", OTHER_HEAD_DIMS)
@pytest.mark.parametrize("blocks", FLASH_BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_at_other_head_dims(card, s, d, blocks, causal):
    """The generic bf16 builds (the head dim passed at run time, the
    padded columns TMA's zero fill, the store guarded) under the bf16
    limit; the last 8 columns carry data."""
    q, k, v = _qkv(2, 8, 2, s, d, card)
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=causal, blocks=blocks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, block_q=blocks[0],
                                 block_k=blocks[1])
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    atol = ATOL_RMS * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    assert np.abs(got[..., d - 8:]).max() > 0


F32_FLASH_CASES = [(d, blocks) for d in (16, 32, 64, 80, 96, 128) for blocks in FLASH_BLOCKS
                   if kflash.built(*blocks, d, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 513, 1024, 2047])
@pytest.mark.parametrize("d,blocks", F32_FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_kernel_matches_plain(card, s, d, blocks, causal):
    """The f32 SIMT kernel at every block pair it is built for, within the
    reference's f32 limit of the plain version in f32."""
    q, k, v = (t.float() for t in _qkv(2, 8, 2, s, d, card))
    before = ops.launch_counts()["flash_attention_f32"]
    got = ops.attention(q, k, v, causal=causal, blocks=blocks)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert ops.launch_counts()["flash_attention_f32"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, block_q=blocks[0],
                                 block_k=blocks[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=F32_RTOL,
                               atol=F32_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 16, 64, 80, 96, 128, 136, 192, 200, 256])
def test_flash_library_stages_what_the_pickers_count(card, d):
    """The shared memory each library kernel launches with is the pickers'
    count (``smem_bytes`` at the dtype's width), and -1 where none is
    built: bf16 and f16 (the wide library past 128), f32."""
    for bq, bk in FLASH_BLOCKS:
        for dtype in (torch.bfloat16, torch.float16):
            lib = kflash.kernel_smem_bytes(bq, bk, d, dtype)
            if kflash.built(bq, bk, d, dtype):
                assert lib == kflash.smem_bytes(bq, bk, d, 2) <= 232_448
            else:
                assert d > 128 and lib == -1
        f32 = kflash.kernel_smem_bytes(bq, bk, d, torch.float32)
        if kflash.built(bq, bk, d, torch.float32):
            assert f32 == kflash.smem_bytes(bq, bk, d, 4) <= 232_448
        else:
            assert f32 == -1
    assert kflash.kernel_smem_bytes(64, 64, 264) == -1
    assert kflash.kernel_smem_bytes(64, 64, 20, torch.float32) == -1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float64, 64), (torch.bfloat16, 264),
                                     (torch.bfloat16, 20), (torch.float32, 136),
                                     (torch.float16, 264), (torch.float16, 20)])
def test_kernel_refuses_what_it_was_not_built_for(card, dtype, d):
    """Still refused, with no launch: f64, f32 at D > 128, 16 bits at D >
    256, D % 8 != 0."""
    q, k, v = (t.to(dtype) for t in _qkv(1, 2, 1, 8, d, card))
    before = ops.launch_counts()
    with pytest.raises((ValueError, TypeError)):
        ops.attention(q, k, v, blocks=(64, 64))
    assert ops.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(32, 32), (16, 64), (64, 256)])
def test_kernel_refuses_unbuilt_blocks(card, blocks):
    q, k, v = _qkv(1, 2, 1, 64, 64, card)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError):
        ops.attention(q, k, v, blocks=blocks)
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.gpu
def test_kernel_on_the_card_never_runs_the_plain_version(card, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(kflash, "flash_attention_plain", boom)
    q, k, v = _qkv(1, 8, 1, 300, 128, card)
    assert ops.attention(q, k, v).shape == (1, 8, 300, 128)


@pytest.mark.gpu
def test_kernel_refuses_non_contiguous(card):
    q, k, v = _qkv(1, 2, 1, 64, 64, card)
    with pytest.raises(ValueError):
        ops.attention(q.transpose(2, 3), k, v)


# matmul: |kernel - plain| <= 2^-7 * |plain| + MM_ATOL_RMS * rms(plain). Both
# sum exact bf16 products in f32 (in another order) and round once, so they
# differ by at most about one bf16 ulp (as in chip_smoke.py).
MM_ATOL_RMS = 0.01


def _ab(m, n, k, device):
    rng = np.random.default_rng(m + 7 * n + 13 * k)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device, torch.bfloat16) for s in ((m, k), (k, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 512, 384), (128, 256, 128),
                                   (2048, 4096, 4096), (2048, 512, 4096),
                                   (2048, 11008, 4096), (2048, 4096, 11008)])
@pytest.mark.parametrize("blocks", [(64, 64, 64), (64, 128, 64), (128, 256, 128),
                                    (128, 64, 128), (64, 256, 64), (128, 128, 128)])
@pytest.mark.parametrize("double_buffer", [False, True])
def test_matmul_kernel_matches_plain(card, shape, blocks, double_buffer):
    a, b = _ab(*shape, card)
    before = ops.launch_counts()["matmul"]
    got = ops.matmul(a, b, blocks=blocks + (double_buffer,))
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul"] == before + 1
    want = kmatmul.matmul_plain(a, b, *blocks).float()
    limit = RTOL * want.abs() + MM_ATOL_RMS * want.pow(2).mean().sqrt()
    assert int(((got.float() - want).abs() > limit).sum()) == 0


def _matmul_within_limit(got, want):
    return _within(got, want, RTOL, MM_ATOL_RMS)[0] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("double_buffer", [False, True])
def test_matmul_persistent_loop_wraps(card, double_buffer):
    """4096 output tiles of 64 x 64 on a grid of (SMs x blocks per SM):
    every block walks many tiles, and the producer runs into each next
    tile while the consumers write the last one."""
    a, b = _ab(4096, 4096, 4096, card)
    got = ops.matmul(a, b, blocks=(64, 64, 64, double_buffer))
    torch.cuda.synchronize()
    assert _matmul_within_limit(got, kmatmul.matmul_plain(a, b, 64, 64, 64))


@pytest.mark.gpu
def test_matmul_has_no_grid_extent_limit(card):
    """M/bm = 65537 row tiles: more than a grid's y extent, which bounded
    the one-block-per-tile kernel; the persistent grid walks them all."""
    a, b = _ab(64 * 65537, 64, 64, card)
    got = ops.matmul(a, b, blocks=(64, 64, 64, True))
    torch.cuda.synchronize()
    assert _matmul_within_limit(got, kmatmul.matmul_plain(a, b, 64, 64, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("bm,bn,bk", list(itertools.product(*kmatmul.BLOCKS.values())))
def test_matmul_library_stages_what_the_model_counts(card, bm, bn, bk):
    """The shared memory the library stages for A and B at each built
    configuration is what ``smem_bytes`` (the sm90 cost model's count)
    says, stage by stage, and fits one block."""
    for db in (False, True):
        staged = kmatmul.kernel_smem_bytes(bm, bn, bk, db)
        assert staged == (2 if db else 1) * kmatmul.smem_bytes(bm, bn, bk, 2)
        assert staged == (2 if db else 1) * (bm * bk + bk * bn) * 2
        assert staged + 128 + 1024 <= 232_448  # + barriers and alignment slack
        # the f32 kernel, where it is built
        f32 = kmatmul.kernel_smem_bytes(bm, bn, bk, db, torch.float32)
        if kmatmul.built(bm, bn, bk, db, torch.float32):
            assert f32 == (2 if db else 1) * kmatmul.smem_bytes(bm, bn, bk, 4)
            assert f32 + 128 + 128 <= 232_448
        else:
            assert f32 == -1
    assert kmatmul.kernel_smem_bytes(32, bn, bk, True) == -1


@pytest.mark.gpu
def test_matmul_launch_replays_in_a_cuda_graph(card):
    """The launch allocates nothing and does not synchronise, so it can be
    captured; a replay reads the inputs' current contents."""
    a, b = _ab(1024, 2048, 1024, card)
    blocks = (128, 256, 128, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.matmul(a, b, blocks=blocks)  # builds, raises the limit, sizes the grid
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()["matmul"]
    with torch.cuda.graph(graph):
        got = ops.matmul(a, b, blocks=blocks)
    assert ops.launch_counts()["matmul"] == before + 1
    a.copy_(torch.flip(a, dims=(0,)))
    graph.replay()
    torch.cuda.synchronize()
    assert _matmul_within_limit(got, kmatmul.matmul_plain(a, b, 128, 256, 128))


@pytest.mark.gpu
def test_matmul_on_the_card_never_runs_the_plain_version(card, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(kmatmul, "matmul_plain", boom)
    a, b = _ab(256, 256, 256, card)
    assert ops.matmul(a, b).shape == (256, 256)  # tuned blocks, the kernel


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f64", "f32-unbuilt", "non-contiguous", "stride",
                                  "unbuilt", "no-longer-built"])
def test_matmul_kernel_refuses(card, case):
    a, b = _ab(256, 256, 256, card)
    blocks = (64, 64, 64)
    if case == "f64":  # f32 and f16 launch their own kernels since they were added
        a, b, err = a.double(), b.double(), TypeError
    elif case == "f32-unbuilt":  # two f32 stages of (128, 128, 128) do not fit
        a, b, blocks, err = a.float(), b.float(), (128, 128, 128), ValueError
    elif case == "non-contiguous":
        b, err = b.t(), ValueError
    elif case == "stride":  # bf16 K = 100: rows of 200 bytes, which TMA cannot step
        a, b = _ab(256, 256, 100, card)
        err = ValueError
    elif case == "unbuilt":
        blocks, err = (16, 64, 64), ValueError
    else:  # 32 left the built set with wgmma's 64-row warpgroup tiles
        blocks, err = (32, 32, 32), ValueError
    before = ops.launch_counts()
    with pytest.raises(err):
        ops.matmul(a, b, blocks=blocks)
    assert ops.launch_counts() == before


@pytest.mark.gpu
def test_matmul_kernel_runs_an_indivisible_shape(card):
    """M = 100 at (64, 64, 64), which the kernel refused before its tiles
    could be ragged: one launch, within the limit of the plain version."""
    a, b = _ab(256, 256, 256, card)
    a = a[:100]
    before = ops.launch_counts()["matmul"]
    got = ops.matmul(a, b, blocks=(64, 64, 64))
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul"] == before + 1
    assert got.shape == (100, 256)
    assert _matmul_within_limit(got, kmatmul.matmul_plain(a, b, 64, 64, 64))


# (M, N, K) that no built tile divides: decode-sized M, M = 96, K = 80, N =
# 8, the reference's indivisible cases, and boxes wholly past the edge (the
# last N box of a bn = 256 tile at N = 320, a bk = 128 stage's second slot
# at K = 192)
RAGGED_MM_SHAPES = [(8, 4096, 4096), (32, 256, 256), (1, 256, 256), (96, 256, 256),
                    (256, 256, 80), (64, 8, 64), (1, 4096, 4096), (32, 4096, 4096),
                    (96, 4096, 4096), (100, 128, 128), (128, 128, 96), (48, 128, 128),
                    (200, 320, 192)]
MM_ALL_CONFIGS = [(bm, bn, bk, db) for bm, bn, bk in itertools.product(
    *kmatmul.BLOCKS.values()) for db in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RAGGED_MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_matmul_ragged_tiles_match_plain(card, shape, dtype):
    """Every built configuration as explicit blocks (the tiles they resolve
    to are ragged here), then the tuner's pick through ops.matmul: one
    launch each, within the limit of the plain version (bf16: one ulp and
    an rms floor; f16 the same at its precision; f32: the reference's)."""
    m, n, k = shape
    a, b = (t.to(dtype) for t in _ab(m, n, k, card))
    key = {torch.bfloat16: "matmul", torch.float32: "matmul_f32",
           torch.float16: "matmul_f16"}[dtype]
    configs = [c for c in MM_ALL_CONFIGS if kmatmul.built(
        *kmatmul.resolve_blocks(m, n, k, *c[:3]), c[3], dtype)]
    for config in configs + [None]:
        before = ops.launch_counts()[key]
        got = ops.matmul(a, b, blocks=config)
        torch.cuda.synchronize()
        assert ops.launch_counts()[key] == before + 1, config
        assert got.shape == (m, n) and got.dtype == dtype
        used = config or ops.tuned_matmul_blocks(m, n, k, a.element_size())
        want = kmatmul.matmul_plain(a, b, *used[:3])
        if dtype == torch.bfloat16:
            assert _matmul_within_limit(got, want), config
        elif dtype == torch.float16:
            assert _within(got, want, F16_RTOL, MM_ATOL_RMS / 8)[0] == 0, config
        else:
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=MM_F32_TOL, atol=MM_F32_TOL * np.sqrt(k),
                                       err_msg=str(config))


MM_F32_CASES = [(bm, bn, bk, db) for bm, bn, bk in itertools.product(*kmatmul.BLOCKS.values())
                for db in (False, True) if kmatmul.built(bm, bn, bk, db, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 512, 384), (128, 256, 128), (256, 256, 256),
                                   (2048, 512, 4096)])
@pytest.mark.parametrize("config", MM_F32_CASES)
def test_matmul_f32_kernel_matches_plain(card, shape, config):
    """The f32 SIMT kernel at every configuration it is built for (blocks
    clamped to the shape, as the reference clamps them), within the
    reference's f32 limit of the plain version."""
    m, n, k = shape
    a, b = (t.float() for t in _ab(m, n, k, card))
    before = ops.launch_counts()["matmul_f32"]
    got = ops.matmul(a, b, blocks=config)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert ops.launch_counts()["matmul_f32"] == before + 1
    want = kmatmul.matmul_plain(a, b, *config[:3])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=MM_F32_TOL,
                               atol=MM_F32_TOL * np.sqrt(k))


# --------------------------------------------------------------------------
# the MoE and hybrid slice: flash at their head groups, MoE ranks, Mamba
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv", [(64, 4), (32, 8), (40, 8)])  # qwen3-moe, jamba, llama4
@pytest.mark.parametrize("s", [64, 77, 513, 2047])
def test_kernel_matches_plain_at_new_head_groups(card, hq, hkv, s):
    """GQA groups 16, 4 and 5 at D=128, causal, with the blocks the main
    path picks."""
    q, k, v = _qkv(1, hq, hkv, s, 128, card)
    blocks = ops.tuned_flash_blocks(s, 128, 2)
    got = ops.attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True, block_q=blocks[0],
                                 block_k=blocks[1])
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    atol = ATOL_RMS * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("e,k,s,cap", [(128, 8, 2047, 159), (16, 2, 2047, 319),
                                       (128, 8, 64, 5), (128, 8, 1, 1)])
def test_moe_dispatch_plan_on_the_card_equals_the_cpus(card, e, k, s, cap):
    """Ranks, kept set, dispatch plan and the emptied slot (0, 0) are a
    function of the routing indices only: equal on both devices."""
    from repro_torch.models import moe

    rng = np.random.default_rng(e + s)
    idx = torch.from_numpy(np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)])
                                     for _ in range(4)]))
    gates = torch.from_numpy(rng.uniform(0.1, 1.0, idx.shape).astype(np.float32))
    cpu = moe.dispatch_plan(idx, gates, cap, e, torch.float32)
    gpu = moe.dispatch_plan(idx.to(card), gates.to(card), cap, e, torch.float32)
    flat = idx.reshape(4, -1)
    assert torch.equal(moe.ranks(flat.to(card)).cpu(), moe.ranks(flat))
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())


def _within(got, want, rtol, atol_rms):
    """(elements outside rtol*|want| + atol_rms*rms(want), worst ratio)."""
    got, want = got.float(), want.float()
    limit = rtol * want.abs() + atol_rms * want.pow(2).mean().sqrt()
    ratio = (got - want).abs() / limit
    return int((ratio > 1).sum()), float(ratio.max())


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk", [(40, 16), (300, 256), (77, 0)])
def test_mamba_forward_on_the_card_matches_stepped_decode(card, s, chunk):
    """bf16 jamba mixer at reduced width: the chunked scan (ragged last
    chunk included) against decode stepped token by token. Limit
    2^-6*|decode| + 0.02*rms(decode): the two round the conv in bf16 in
    another order (one or two bf16 ulps of u), which the f32 scan carries
    into y and the bf16 out-projection sums over d_inner."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config("jamba_v01_52b").reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    p = ssm.init_mamba(cfg, torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(s)
    x = torch.from_numpy(0.5 * rng.standard_normal((2, s, cfg.d_model)).astype(np.float32))
    x = x.to(card, torch.bfloat16)
    y, st = ssm.mamba_forward(cfg, p, x, chunk=chunk, return_state=True)
    cache = ssm.init_mamba_cache(cfg, 2, torch.bfloat16, card)
    ys = []
    for t in range(s):
        yt, cache = ssm.mamba_decode(cfg, p, x[:, t:t + 1], cache)
        ys.append(yt)
    for got, want, rtol, atol_rms in ((y, torch.cat(ys, dim=1), 2**-6, 0.05),
                                      (st["h"], cache["h"], 2**-6, 0.02),
                                      (st["conv"], cache["conv"], 2**-7, 0.0)):
        bad, worst = _within(got, want, rtol, atol_rms)
        assert bad == 0, f"{bad} outside, worst at {worst:.3f} of the limit"


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 513, 1024, 2047])
@pytest.mark.parametrize("d", HEAD_DIMS + (96,))
@pytest.mark.parametrize("blocks", FLASH_BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_f16_kernel_matches_plain(card, s, d, blocks, causal):
    """The f16 kernel (its own library) at every block pair, the built head
    dims and a generic one, within the f16 limit of the plain version in
    f16; one f16 launch and no bf16 one."""
    q, k, v = (t.half() for t in _qkv(2, 8, 2, s, d, card))
    before = ops.launch_counts()
    got = ops.attention(q, k, v, causal=causal, blocks=blocks)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16
    assert ops.launch_counts() == dict(
        before, flash_attention_f16=before["flash_attention_f16"] + 1)
    want = flash_attention_plain(q, k, v, causal=causal, block_q=blocks[0],
                                 block_k=blocks[1])
    bad, worst = _f16_within(got, want, q, k, v, causal)
    assert bad == 0, f"{bad} outside, worst at {worst:.3f} of the limit"


WIDE_CASES = [(d, blocks) for d in WIDE_HEAD_DIMS for blocks in FLASH_BLOCKS
              if kflash.built(*blocks, d, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 513, 1024])
@pytest.mark.parametrize("d,blocks", WIDE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_kernel_matches_plain(card, s, d, blocks, dtype, causal):
    """Head dims past 128 (the wide library, padded to 192 or 256 columns)
    at every block pair built for them, in both 16-bit types, within each
    type's limit of the plain version; the last 64-column atom carries
    data, and a kernel that lost it would be flagged."""
    q, k, v = (t.to(dtype) for t in _qkv(2, 8, 2, s, d, card))
    key = "flash_attention" if dtype == torch.bfloat16 else "flash_attention_f16"
    before = ops.launch_counts()[key]
    got = ops.attention(q, k, v, causal=causal, blocks=blocks)
    torch.cuda.synchronize()
    assert ops.launch_counts()[key] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, block_q=blocks[0],
                                 block_k=blocks[1])
    within = (functools.partial(_within, rtol=RTOL, atol_rms=ATOL_RMS)
              if dtype == torch.bfloat16 else
              lambda g, w: _f16_within(g, w, q, k, v, causal))
    bad, worst = within(got, want)
    assert bad == 0, f"{bad} outside, worst at {worst:.3f} of the limit"
    last = (kflash.padded_head_dim(d) - 64)
    lost = got.clone()
    lost[..., last:] = 0
    assert within(lost, want)[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 512, 384), (2048, 4096, 4096), (2048, 512, 4096)])
def test_f16_matmul_kernel_matches_plain(card, shape):
    """The f16 matmul (its own library) at every built configuration, then
    the tuner's pick (bf16's: the same width) through ops.matmul, within
    the f16 limit of the plain version; the library stages what the sm90
    model counts."""
    a, b = (t.half() for t in _ab(*shape, card))
    for config in MM_ALL_CONFIGS + [None]:
        before = ops.launch_counts()
        got = ops.matmul(a, b, blocks=config)
        torch.cuda.synchronize()
        assert ops.launch_counts() == dict(before, matmul_f16=before["matmul_f16"] + 1)
        used = config or ops.tuned_matmul_blocks(*shape, 2)
        want = kmatmul.matmul_plain(a, b, *used[:3])
        assert got.dtype == torch.float16
        assert _within(got, want, F16_RTOL, MM_ATOL_RMS / 8)[0] == 0, config
    for bm, bn, bk, db in MM_ALL_CONFIGS:
        assert (kmatmul.kernel_smem_bytes(bm, bn, bk, db, torch.float16)
                == kmatmul.kernel_smem_bytes(bm, bn, bk, db))


@pytest.fixture
def bundle_records():
    """A bf16 matmul, an f32 matmul and a bf16 flash record the Hopper
    kernels run, and an f32 matmul record at tiles whose two stages do not
    fit, which a CUDA bundle keeps in its schedule index only."""
    from repro_torch.core import op_registry
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.tuna.db import ScheduleRecord

    mm = MatmulSpace(256, 256, 512, 2, target_kind="sm90").signature()
    mm32 = MatmulSpace(256, 256, 512, 4, target_kind="sm90").signature()
    fl = op_registry.make_space("flash", {"s": 256, "d": 128, "dtype_bytes": 2},
                                "sm90").signature()
    mm32_big = MatmulSpace(512, 512, 512, 4, target_kind="sm90").signature()
    cfg = {"bm": 128, "bn": 128, "bk": 64, "double_buffer": True}
    return [ScheduleRecord(op=mm, target="gpu_h100", score=1e-6, config=cfg),
            ScheduleRecord(op=mm32, target="gpu_h100", score=1e-6, config=cfg),
            ScheduleRecord(op=mm32_big, target="gpu_h100", score=1e-6,
                           config=dict(cfg, bk=128)),
            ScheduleRecord(op=fl, target="gpu_h100", score=1e-6,
                           config={"block_q": 128, "block_k": 64})]


@pytest.mark.gpu
def test_cuda_bundle_launches_its_library_with_no_build(card, tmp_path, bundle_records):
    """A CUDA bundle built from this checkout's libraries, installed: the
    calls without blocks launch from the bundled library (written under
    build/kernels/bundled) at the record's blocks, with no nvcc run, bit
    for bit the launches of the built library; removing the bundle puts
    the built library back."""
    from repro_torch.kernels import build
    from repro_torch.tuna.golden import build_kernel_bundle

    info = build_kernel_bundle(bundle_records, str(tmp_path), "gpu_h100")
    assert (info.entries, len(info.skipped)) == (3, 1)
    assert "shared memory" in info.skipped[0][1]
    assert sorted(info.libraries) == sorted(build.SOURCES)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(card, torch.bfloat16) for s in ((256, 512), (512, 256)))
    q = torch.from_numpy(rng.standard_normal((1, 1, 256, 128)).astype(np.float32))
    q = q.to(card, torch.bfloat16)
    x32, y32 = x.float(), y.float()
    base_mm = ops.matmul(x, y, blocks=(128, 128, 64, True))
    base_mm32 = ops.matmul(x32, y32, blocks=(128, 128, 64, True))
    base_att = ops.attention(q, q, q, blocks=(128, 64))
    assert build.load("matmul")._name == str(build.library_path("matmul"))
    ops.use_kernel_bundle(info.path)
    try:
        installed = build.installed()
        assert {n: p.parent.name for n, p in installed.items()} == \
            {n: "bundled" for n in build.SOURCES}
        builds, launches = ops.kernel_build_counts(), ops.launch_counts()
        got_mm, got_att = ops.matmul(x, y), ops.attention(q, q, q)
        got_mm32 = ops.matmul(x32, y32)
        torch.cuda.synchronize()
        assert build.load("matmul")._name == str(installed["matmul"])
        assert build.load("flash_attention")._name == str(installed["flash_attention"])
        assert ops.get_kernel_bundle().exec_hits == 3
        assert ops.kernel_build_counts() == builds
        assert ops.launch_counts() == dict(
            launches, matmul=launches["matmul"] + 1, matmul_f32=launches["matmul_f32"] + 1,
            flash_attention=launches["flash_attention"] + 1)
        assert torch.equal(got_mm, base_mm) and torch.equal(got_att, base_att)
        assert torch.equal(got_mm32, base_mm32)
    finally:
        ops.use_kernel_bundle(None)
    assert build.installed() == {}
    assert build.load("matmul")._name == str(build.library_path("matmul"))


@pytest.mark.gpu
def test_cuda_bundle_of_bf16_records_sends_f16_calls_to_the_f16_kernel(
        card, tmp_path, bundle_records):
    """An f16 call at a bundled bf16 record's shape misses the bundle (its
    entries are keyed by "bfloat16"), takes the record's blocks from the
    bundle's index and launches the f16 kernel from the bundled matmul_f16
    library, with no nvcc run: bit for bit the explicit f16 launch, and no
    bf16 launch."""
    from repro_torch.kernels import build
    from repro_torch.tuna.golden import build_kernel_bundle

    info = build_kernel_bundle(bundle_records, str(tmp_path), "gpu_h100")
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(card, torch.float16) for s in ((256, 512), (512, 256)))
    q = torch.from_numpy(rng.standard_normal((1, 1, 256, 128)).astype(np.float32))
    q = q.to(card, torch.float16)
    want_mm = ops.matmul(x, y, blocks=(128, 128, 64, True))
    want_att = ops.attention(q, q, q, blocks=(128, 64))
    ops.use_kernel_bundle(info.path)
    try:
        builds, launches = ops.kernel_build_counts(), ops.launch_counts()
        got_mm, got_att = ops.matmul(x, y), ops.attention(q, q, q)
        torch.cuda.synchronize()
        bundle = ops.get_kernel_bundle()
        assert (bundle.exec_hits, bundle.exec_misses) == (0, 2)
        assert ops.kernel_build_counts() == builds
        assert ops.launch_counts() == dict(
            launches, matmul_f16=launches["matmul_f16"] + 1,
            flash_attention_f16=launches["flash_attention_f16"] + 1)
        assert build.load("matmul_f16")._name == str(build.installed()["matmul_f16"])
        assert torch.equal(got_mm, want_mm) and torch.equal(got_att, want_att)
    finally:
        ops.use_kernel_bundle(None)


@pytest.mark.gpu
def test_cuda_bundle_launches_a_ragged_record(card, tmp_path):
    """A record at a shape no built tile divides (M = 96, its tuned ragged
    pick) in a CUDA bundle: the call without blocks launches from the
    bundled library with no nvcc run, bit for bit the explicit call."""
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.tuna.db import ScheduleRecord
    from repro_torch.tuna.golden import build_kernel_bundle

    pick = ops.tuned_matmul_blocks(96, 256, 256, 2)
    rec = ScheduleRecord(op=MatmulSpace(96, 256, 256, 2, target_kind="sm90").signature(),
                         target="gpu_h100", score=1e-6,
                         config=dict(zip(("bm", "bn", "bk", "double_buffer"), pick)))
    info = build_kernel_bundle([rec], str(tmp_path), "gpu_h100")
    assert (info.entries, len(info.skipped)) == (1, 0)
    x, y = _ab(96, 256, 256, card)
    want = ops.matmul(x, y, blocks=pick)
    ops.use_kernel_bundle(info.path)
    try:
        builds, launches = ops.kernel_build_counts(), ops.launch_counts()["matmul"]
        got = ops.matmul(x, y)
        torch.cuda.synchronize()
        assert ops.get_kernel_bundle().exec_hits == 1
        assert ops.kernel_build_counts() == builds
        assert ops.launch_counts()["matmul"] == launches + 1
    finally:
        ops.use_kernel_bundle(None)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_bundle_refuses_a_corrupt_library(card, tmp_path, bundle_records):
    import json

    from repro_torch.tuna.golden import BundleError, KernelBundle, build_kernel_bundle

    info = build_kernel_bundle(bundle_records, str(tmp_path), "gpu_h100")
    bundle = KernelBundle.load(info.latest)
    assert bundle.arch == "sm_90a" and bundle.backend == "torch-cuda"
    obj = json.load(open(info.path))
    blob = obj["libraries"]["matmul"]["b64"]
    obj["libraries"]["matmul"]["b64"] = ("A" if blob[0] != "A" else "B") + blob[1:]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(obj))
    with pytest.raises(BundleError, match="sha1"):
        KernelBundle.load(str(bad))
    with pytest.raises(BundleError, match="backend"):
        KernelBundle.load(info.path, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("mixer,s", [("mlstm", 16), ("mlstm", 13), ("slstm", 16)])
def test_xlstm_mixer_on_the_card_matches_the_cpu(card, mixer, s):
    """The reduced xlstm-1.3b mixers in f32 (TF32 off) on the card against
    the same code on the CPU, on the same weights and input: the chunkwise
    mLSTM (chunk 8, and one token per chunk at S=13) or the sLSTM scan,
    output and final state, then three decode steps from that state.
    Limit 1e-4 absolute and relative: f32 on both sides, summed in
    another order (each mixer alone is well conditioned; the CPU tests
    hold it to the reference at the same limit)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import xlstm

    cfg = get_config("xlstm_13b").reduced()
    init = xlstm.init_mlstm if mixer == "mlstm" else xlstm.init_slstm
    forward = xlstm.mlstm_forward if mixer == "mlstm" else xlstm.slstm_forward
    decode = xlstm.mlstm_decode if mixer == "mlstm" else xlstm.slstm_decode
    p = init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(s)
    x = torch.from_numpy(0.5 * rng.standard_normal((2, s + 3, cfg.d_model)).astype(np.float32))
    outs = []
    for dev in ("cpu", card):
        pd = {k: v.to(dev) for k, v in p.items()}
        y, state = forward(cfg, pd, x[:, :s].to(dev), return_state=True)
        steps = []
        for t in range(s, s + 3):
            yt, state = decode(cfg, pd, x[:, t:t + 1].to(dev), state)
            steps.append(yt)
        outs.append([y, torch.cat(steps, dim=1)] + [state[k] for k in sorted(state)])
    for want, got in zip(*outs):
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,s,d,causal", [(8, 2, 77, 128, True), (8, 2, 513, 128, True),
                                               (4, 4, 300, 64, False), (4, 4, 200, 80, True)])
def test_flash_gradients_on_the_card(card, hq, hkv, s, d, causal):
    """dq, dk, dv through ``ops.attention`` (the kernel's forward, one
    launch, then ``flash_attention_backward``) in bf16 against autograd
    through the plain version on f32 copies of the same inputs, within the
    forward's limit RTOL*|plain| + ATOL_RMS*rms(plain) (the gradients are
    rounded to bf16 once)."""
    q, k, v = _qkv(2, hq, hkv, s, d, card)
    do = _qkv(2, hq, hkv, s, d, card)[0].flip(2).contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention"]
    got = torch.autograd.grad(ops.attention(*leaves, causal=causal), leaves, do)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, causal=causal), ref, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().cpu().numpy(), w.cpu().numpy()
        atol = ATOL_RMS * float(np.sqrt(np.mean(w ** 2)))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol)


@pytest.mark.gpu
def test_one_by_one_nccl_mesh_train_step_is_bit_equal_on_the_card(card):
    """Two train steps of reduced yi-6b, widened to head dim 64 in bf16 so
    that its attention takes the flash kernel (through ``local_map``), on a
    1x1 mesh over a one-rank NCCL group: the losses, the gradient norms and
    every parameter and moment leaf equal the meshless steps' bit for bit,
    and both launch the kernel once per layer per step."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel import sharding as sh

    cfg = dataclasses.replace(get_config("yi_6b").reduced(), d_model=256, d_head=64,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    assert cfg.head_dim == 64
    model, opt = Model(cfg, device=card), adamw.AdamWConfig(state_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in
               (rng.integers(0, cfg.vocab, (4, 129)).astype(np.int32) for _ in range(2))]
    kw = dict(accum_steps=2, grad_compression="int8")
    started = not dist.is_initialized()
    mesh_mod.init_process_group("cuda")
    try:
        runs = []
        for meshed in (False, True):
            params = model.init(torch.Generator(device=card).manual_seed(0))
            state = adamw.init_state(opt, params)
            mesh = None
            if meshed:
                mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
                pctx.install(("data",), tp_size=1, mesh=mesh)
                p_sh = sh.params_sharding(params, mesh)
                state = sh.distribute(state, sh.opt_state_sharding(state, params, mesh), mesh)
                params = sh.distribute(params, p_sh, mesh)
                kw["grad_shardings"] = p_sh
            ops.reset_launch_counts()
            metrics = []
            try:
                for i, batch in enumerate(batches):
                    step = steps.make_train_step(model, opt, **(kw if i else {}))
                    params, state, m = step(params, state, batch)
                    metrics.append({k: float(v) for k, v in m.items()})
            finally:
                pctx.clear()
            local = lambda t: t.to_local() if hasattr(t, "to_local") else t
            runs.append((metrics, [local(t) for t in tree.leaves((params, state))],
                         ops.launch_counts()["flash_attention"]))
        (m0, l0, n0), (m1, l1, n1) = runs
        assert m0 == m1 and n0 == n1 == 3 * cfg.n_layers * 2  # 3 passes, fwd + remat
        assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()

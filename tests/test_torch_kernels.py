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
    """The (block_q, block_k, d) triples csrc/flash_attention.cu builds in
    bf16 are BLOCKS x BLOCKS x HEAD_DIMS, its generic builds BLOCKS x BLOCKS
    x PADDED_WIDTHS, and its f32 builds the (block_q, block_k, padded
    width) that ``built`` admits; the bf16 products are wgmma, the f32
    kernel's are not."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert _macro(src, "FLASH_BUILT") == {
        (bq, bk, d) for bq in BLOCKS for bk in BLOCKS for d in HEAD_DIMS}
    assert HEAD_DIMS == (64, 80, 128) and PADDED_WIDTHS == (64, 128)
    assert _macro(src, "FLASH_ANY_D_BUILT") == {
        (bq, bk, dp) for bq in BLOCKS for bk in BLOCKS for dp in PADDED_WIDTHS}
    assert _macro(src, "FLASH_F32_BUILT") == {
        (bq, bk, dp) for bq in BLOCKS for bk in BLOCKS for dp in PADDED_WIDTHS
        if kflash.built(bq, bk, dp, torch.float32)}
    assert "wgmma_ss" in src and "wgmma_rs" in src and "mma.sync" not in src
    # tiles and accumulator at the padded width, the store at the real one
    assert "int DP = (D + 63) / 64 * 64" in src and "wgmma_rs<C::kDP, 1>" in src
    assert "col >= dd" in src
    # the f32 entry points beside the bf16 ones; the f32 kernel stages with
    # cp.async and multiplies by FFMA (fmaf), with no tensor-core product
    for entry in ("flash_attention_fwd_bf16", "flash_attention_fwd_f32",
                  "flash_attention_smem_bytes", "flash_attention_f32_smem_bytes"):
        assert f'extern "C" int {entry}(' in src
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
                                  (132, False), (136, False)])
def test_supports_head_dim_at_the_rules_edges(d, ok):
    """A multiple of 8 (TMA's 16-byte row stride in bf16) from 8 to 128."""
    assert supports_head_dim(d) is ok
    assert kflash.built(64, 64, d, torch.bfloat16) is ok
    assert kflash.built(64, 64, d, torch.float32) is ok


@pytest.mark.parametrize("bq", BLOCKS)
@pytest.mark.parametrize("bk", BLOCKS)
@pytest.mark.parametrize("dp", PADDED_WIDTHS)
def test_f32_flash_smem_is_the_kernels_count(bq, bk, dp):
    """The f32 kernel stages Q [bq][dp], two stages of K and V [bk][dp] and
    P [bq][bk], all f32, with no barrier and no slack; it is built exactly
    where that fits one H100 block."""
    hand = 4 * (bq * dp + 2 * 2 * bk * dp + bq * bk)
    assert smem_bytes(bq, bk, dp, 4) == hand == smem_bytes(bq, bk, dp - 8, 4)
    assert kflash.built(bq, bk, dp, torch.float32) is (hand <= GPU_H100.fast_mem_bytes)
    assert kflash.built(bq, bk, dp, torch.bfloat16)
    assert smem_bytes(bq, bk, dp, 2) == smem_bytes(bq, bk, dp)


@pytest.mark.parametrize("s", [1, 12, 64, 77, 513, 1024, 2047])
@pytest.mark.parametrize("d", [8, 16, 48, 64, 80, 96, 128])
def test_tuned_flash_blocks_fit_the_f32_kernel(s, d):
    """Every f32 pick is a block pair the f32 kernel is built for."""
    bq, bk = ops.tuned_flash_blocks(s, d, 4)
    assert kflash.built(bq, bk, d, torch.float32)
    assert smem_bytes(bq, bk, d, 4) <= GPU_H100.fast_mem_bytes


@pytest.mark.parametrize("dtype,d,blocks,err", [
    (torch.float16, 64, (64, 64), TypeError),     # f16: no kernel
    (torch.float32, 136, (64, 64), ValueError),   # D > 128
    (torch.bfloat16, 20, (64, 64), ValueError),   # D % 8 != 0
    (torch.float32, 128, (128, 128), ValueError),  # f32 blocks that do not fit
    (torch.bfloat16, 64, (32, 64), ValueError),   # blocks never built
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
    assert ops.launch_counts() == {"flash_attention": 0, "matmul": 0,
                                   "flash_attention_f32": 0, "matmul_f32": 0}


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
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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
    (100, 128, 128, (64, 64, 64)),   # indivisible (the reference's case)
    (128, 128, 96, (64, 64, 64)),    # K not divisible by bk
    (128, 128, 128, (16, 64, 64)),   # bm never built
    (48, 128, 128, (64, 64, 64)),    # bm clamps to an unbuilt 48
])
def test_matmul_refuses_unbuilt_or_indivisible_blocks(m, n, k, blocks):
    x, y = _torch(_xy(m, n, k))
    with pytest.raises(ValueError):
        ops.matmul(x, y, blocks=blocks)
    with pytest.raises(ValueError):
        kmatmul.matmul_plain(x, y, *blocks)


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
    """The (bm, bn, bk) tiles csrc/matmul.cu instantiates (each with one and
    two stages) are exactly the sm90 knob values the tuner ranks
    (core/spaces.SM90_MATMUL_TILES): bm {64, 128}, bn {64, 128, 256}, bk
    {64, 128}. Its products are wgmma and its loads TMA."""
    src = (build.CSRC / "matmul.cu").read_text()
    macro = re.search(r"#define MM_BUILT\(X\)(.*?)\n\n", src, re.S).group(1)
    built = [tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", macro)]
    assert SM90_MATMUL_TILES == kmatmul.BLOCKS == {
        "bm": (64, 128), "bn": (64, 128, 256), "bk": (64, 128)}
    assert sorted(built) == sorted(itertools.product(*SM90_MATMUL_TILES.values()))
    assert "launch<BM_, BN_, BK_, 2>" in src and "launch<BM_, BN_, BK_, 1>" in src
    assert "wgmma_ss<BN, 1>" in src and "tma_load_3d" in src
    assert "mma.sync" not in src and "cp.async" not in src
    assert not re.search(r"gemm|gemv|xmma|nvjet", src, re.IGNORECASE)
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


@pytest.mark.parametrize("dtype,n,blocks,err", [
    (torch.float16, 128, (64, 64, 64, True), TypeError),     # f16: no kernel
    (torch.float32, 128, (128, 128, 128, True), ValueError),  # two stages do not fit
    (torch.float32, 256, (128, 256, 128, True), ValueError),
    (torch.bfloat16, 128, (64, 64, 32, True), ValueError),   # bk never built
])
def test_matmul_launch_refuses_what_no_kernel_is_built_for(monkeypatch, dtype, n,
                                                           blocks, err):
    """The wrapper's launch refuses before it loads a library; the f32 one
    at (128, 128, 128) launches with one stage."""
    monkeypatch.setattr(kmatmul, "_kernel", lambda entry: pytest.fail("loaded"))
    x, y = torch.zeros((128, 128), dtype=dtype), torch.zeros((128, n), dtype=dtype)
    with pytest.raises(err):
        kmatmul._launch(x, y, *blocks)
    assert kmatmul.built(128, 128, 128, False, torch.float32)

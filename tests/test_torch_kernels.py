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
from repro_torch.kernels.flash_attention import (BLOCKS, HEAD_DIMS, flash_attention,
                                                 flash_attention_plain, padded_head_dim,
                                                 smem_bytes)
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


def test_flash_source_instantiates_exactly_the_built_blocks():
    """The (block_q, block_k, d) triples csrc/flash_attention.cu builds are
    BLOCKS x BLOCKS x HEAD_DIMS, and the kernel's products are wgmma."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    macro = re.search(r"#define FLASH_BUILT\(X\)(.*?)\n\n", src, re.S).group(1)
    built = {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", macro)}
    assert built == {(bq, bk, d) for bq in BLOCKS for bk in BLOCKS for d in HEAD_DIMS}
    assert HEAD_DIMS == (64, 80, 128)
    assert "wgmma_ss" in src and "wgmma_rs" in src and "mma.sync" not in src
    # tiles and accumulator at the padded width, the store at the real one
    assert "kDP = (D + 63) / 64 * 64" in src and "wgmma_rs<C::kDP, 1>" in src


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
    assert ops.launch_counts() == {"flash_attention": 0, "matmul": 0}


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

"""The port's flash attention (plain blocked version on the CPU, the CUDA
kernel on a card) held against the reference's Pallas kernel in interpret
mode and the reference oracle, on the same numpy-seeded inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import chunked_attention as jchunked
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import (BLOCKS, flash_attention,
                                                 flash_attention_plain)
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
@pytest.mark.parametrize("d", [16, 64, 128])
def test_tuned_flash_blocks_fit_the_kernel(s, d):
    bq, bk = ops.tuned_flash_blocks(s, d, 2)
    assert bq in BLOCKS and bk in BLOCKS
    assert (bq + 2 * bk) * (d * 2 + 16) <= GPU_H100.fast_mem_bytes
    assert ops.tuned_flash_blocks(s, d, 2) is ops.tuned_flash_blocks(s, d, 2)


def test_tuned_flash_blocks_shrink_for_short_prompts():
    """A prompt no longer than the smallest block gets the smallest tiles:
    larger ones stage more bytes for the same single step."""
    assert ops.tuned_flash_blocks(1, 128, 2) == (16, 16)
    assert ops.tuned_flash_blocks(1024, 128, 2) == (128, 128)


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
    ops.attention(*arrs)  # CPU: the plain version, not a launch
    assert ops.launch_counts() == {"flash_attention": 0}


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

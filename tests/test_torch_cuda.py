"""The port's CUDA kernel held against its plain torch version on the card.

Imports no jax, so it runs where only the port is installed:
    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_plain

# |kernel - plain| <= RTOL * |plain| + ATOL_RMS * rms(plain): one bf16 ulp of
# the output, plus a floor for outputs near zero (as in chip_smoke.py)
RTOL, ATOL_RMS = 2**-7, 0.02


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
@pytest.mark.parametrize("s", [1, 77, 513, 1024])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("blocks", [(16, 32), (64, 64), (128, 128), (32, 128)])
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
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 16), (torch.float32, 64)])
def test_kernel_refuses_what_it_was_not_built_for(card, dtype, d):
    q, k, v = (t.to(dtype) for t in _qkv(1, 2, 1, 8, d, card))
    with pytest.raises((ValueError, TypeError)):
        ops.attention(q, k, v)


@pytest.mark.gpu
def test_kernel_refuses_non_contiguous(card):
    q, k, v = _qkv(1, 2, 1, 64, 64, card)
    with pytest.raises(ValueError):
        ops.attention(q.transpose(2, 3), k, v)

"""The port's training path held against the reference's on the CPU: the
flash backward and ``Model.loss`` with its gradient for every arch, on
numpy-seeded inputs and ``from_jax`` weights (the train step, the optimizer,
data, checkpoints and the trainer are in test_torch_substrate.py).

Tolerances (f32 on both sides):

- The flash backward against ``jax.grad`` of ``repro.kernels.ref.attention``:
  ``FLASH_TOL``, rtol 1e-5 with an absolute floor of 1e-5: the same
  formulas in f32, blocked and summed in another order. dQ and dK are sums
  over keys of dS·K whose terms, of order one, cancel to order 1e-2, so the
  rounding of those sums leaves up to about 2e-6 absolute at small elements.
- ``Model.loss`` and every parameter's gradient: ``TOL`` (1e-4 absolute and
  relative), as the forward parity of test_torch_models.py, except the
  xLSTM stack. Its gradients reach 1.9e3 at reduced size and are
  ill-conditioned: multiplying the reference's own parameters by 1 ± 2⁻²³
  (one f32 ulp, three seeds) moves its gradient by up to 39.75 at an
  element of the embedding table. Its two mixers alone hold to TOL
  (``test_xlstm_mixer_gradients_match``); the stack holds to
  ``STACK_GRAD_TOL``: 5e-2 (test_torch_xlstm.py's ``STACK_TOL``) times the
  leaf's largest reference gradient, absolute, per element.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import xlstm as jxlstm
from repro.models.model import Model as JModel
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import xlstm
from repro_torch.models.model import Model
from repro_torch.weights import from_jax

FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
STACK_GRAD_TOL = 5e-2
B, S = 2, 16


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.detach().float().numpy()


# --------------------------------------------------------------------------
# the flash backward
# --------------------------------------------------------------------------


def _qkv(hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, hq, s, d), (2, hkv, s, d), (2, hkv, s, d), (2, hq, s, d))]


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_backward_matches_reference_grad(group, causal, d, monkeypatch):
    """dq, dk, dv at S=77 (not a multiple of any block), GQA groups 1 and 4:
    the backward alone over blocks of 16 query rows (``BWD_BLOCK_ELEMS``
    shrunk to 16 rows' worth) and of all 77, and the gradient through
    ``ops.attention`` (the autograd function), against ``jax.grad`` of the
    reference's full-softmax oracle."""
    q, k, v, do = _qkv(4 * group, 4, 77, d)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention(q, k, v, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    for elems in (16 * q.shape[0] * q.shape[1] * 77, fa.BWD_BLOCK_ELEMS):
        monkeypatch.setattr(fa, "BWD_BLOCK_ELEMS", elems)
        got = fa.flash_attention_backward(tq, tk, tv, tdo, causal=causal)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **FLASH_TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, tdo)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **FLASH_TOL)


def test_flash_backward_returns_the_input_dtype():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(8, 2, 33, 16))
    dq, dk, dv = fa.flash_attention_backward(q, k, v, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_bundle_branch_is_differentiable(monkeypatch):
    """A call served by an installed kernel bundle's entry goes through the
    same autograd function: its output has a gradient, equal to the one
    through the statically picked blocks."""
    q, k, v, do = map(torch.from_numpy, _qkv(8, 2, 40, 16))
    served = []

    def bundle_entry(kernel, args, params):
        served.append(kernel)
        return lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=params["causal"],
                                                        scale=params["scale"])

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.attention(*leaves, blocks=(64, 64)), leaves, do)
    monkeypatch.setattr(ops, "_bundle_executable", bundle_entry)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*leaves)
    assert served == ["flash"] and out.grad_fn is not None
    for a, b in zip(torch.autograd.grad(out, leaves, do), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_reference_cannot_differentiate_its_flash_kernel():
    """The reference's Pallas flash call has no VJP: ``jax.grad`` through
    ``flash_attention_pallas`` (interpret mode) raises, so on a TPU, where
    ``ops.attention`` takes that path below 4096 tokens, its train step
    crashes. The port's gradient at the same inputs is the one the
    reference computes where it can train: ``jax.grad`` of its oracle."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, 128, 64)).astype(np.float32) for _ in range(2))

    def pallas_loss(q, k, v):
        return jnp.sum(flash_attention_pallas(q, k, v, causal=True, block_q=64,
                                              block_k=64, interpret=True))

    with pytest.raises(AssertionError):
        jax.grad(pallas_loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(lambda q, k, v: jnp.sum(jref.attention(q, k, v, causal=True)),
                    argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(ops.attention(*leaves, causal=True, blocks=(64, 64)).sum(),
                              leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **FLASH_TOL)


# --------------------------------------------------------------------------
# Model.loss and its gradient, every arch
# --------------------------------------------------------------------------


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend:
        key = "frames" if cfg.frontend == "audio" else "patches"
        batch[key] = (0.1 * rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                      ).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JModel(jget_config(arch).reduced()).init(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grad(arch, remat=True):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat_stack=remat)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(JModel(jcfg).loss, has_aux=True))(
        _jparams(arch), jbatch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [np.asarray(g) for g in jax.tree.leaves(grads)])


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_reference(arch, remat):
    """The port with per-group remat on and off, each against the
    reference's ``jax.value_and_grad(Model.loss)`` with its config's remat
    (on): the reference's numbers do not depend on it
    (``test_reference_gradient_does_not_depend_on_remat``)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat_stack=remat)
    want_loss, want_metrics, want_grads = _reference_loss_and_grad(arch)
    params = from_jax(jax.tree.map(np.asarray, _jparams(arch)), device="cpu")
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = Model(cfg, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(want_metrics)
    for key, val in metrics.items():
        np.testing.assert_allclose(float(val.detach()), want_metrics[key], **TOL)
    np.testing.assert_allclose(float(loss.detach()), want_loss, **TOL)
    assert len(grads) == len(want_grads)
    for path, g, want in zip(tree.paths(params), grads, want_grads):
        assert tuple(g.shape) == want.shape, path
        tol = (dict(atol=STACK_GRAD_TOL * float(np.abs(want).max()), rtol=0)
               if cfg.family == "ssm" else TOL)
        np.testing.assert_allclose(_np(g), want, err_msg=path, **tol)


DENSE_ARCHS = ("yi_6b", "stablelm_3b", "nemotron_4_15b", "qwen25_14b",
               "whisper_large_v3", "internvl2_1b")
BF16_GRAD_FACTOR = 2.0


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_bf16_gradient_error_within_twice_the_reference_own(arch):
    """The dense archs in bf16 (reduced configs cast to bf16, B=2, S=16):
    for every leaf, the port's bf16 gradient is no further from the f32
    reference's than ``BF16_GRAD_FACTOR`` times the reference's own bf16
    gradient, each distance max |g - g_f32| over max |g_f32|."""
    to16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    _, _, want32 = _reference_loss_and_grad(arch)
    jcfg16 = dataclasses.replace(jget_config(arch).reduced(), **to16)
    jparams16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _jparams(arch))
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg16).items()}
    jgrads = jax.tree.leaves(jax.jit(jax.grad(
        lambda p, b: JModel(jcfg16).loss(p, b)[0]))(jparams16, jbatch))
    cfg16 = dataclasses.replace(get_config(arch).reduced(), **to16)
    params = from_jax(jax.tree.map(np.asarray, jparams16), device="cpu")
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = Model(cfg16, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in _batch(cfg16).items()})
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(jgrads) == len(want32)
    for path, g, jg, want in zip(tree.paths(params), grads, jgrads, want32):
        assert g.dtype == torch.bfloat16, path
        scale = float(np.abs(want).max())
        port = float(np.abs(_np(g) - want).max()) / scale
        ref = float(np.abs(_np(jg) - want).max()) / scale
        assert port <= BF16_GRAD_FACTOR * ref, (path, port, ref)


def test_moe_gradient_with_capacity_drops_matches_reference():
    """Reduced qwen3-moe at capacity factor 0.5, where assignments are
    dropped and the reference empties slot (0, 0) (``dispatch_plan``'s
    in-place writes run under autograd): the loss and every gradient, the
    router's included, within TOL."""
    def drop(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))

    jcfg = drop(jget_config("qwen3_moe_235b_a22b").reduced())
    cfg = drop(get_config("qwen3_moe_235b_a22b").reduced())
    jp = JModel(jcfg).init(jax.random.key(2))
    batch = _batch(cfg, seed=3)
    (jl, _), jg = jax.jit(jax.value_and_grad(JModel(jcfg).loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = Model(cfg, device="cpu").loss(params, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for path, g, want in zip(tree.paths(params), grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(g), np.asarray(want), err_msg=path, **TOL)
    router = grads[tree.paths(params).index("['layers'][0]['mlp']['router']")]
    assert float(router.abs().max()) > 0


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_moe_235b_a22b"])
def test_reference_gradient_does_not_depend_on_remat(arch):
    """The reference's loss and gradients with ``remat_stack`` off equal
    those with it on, bit for bit, on the inputs of the test above."""
    on, off = _reference_loss_and_grad(arch, True), _reference_loss_and_grad(arch, False)
    assert on[:2] == off[:2]
    for a, b in zip(on[2], off[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_mixer_gradients_match(mixer):
    """Each xLSTM mixer alone (reduced xlstm-1.3b, S=16: two mLSTM chunks
    of 8) differentiates to the reference's gradient within TOL, for its
    parameters and its input."""
    jcfg, cfg = jget_config("xlstm_13b").reduced(), get_config("xlstm_13b").reduced()
    init = {"mlstm": jxlstm.init_mlstm, "slstm": jxlstm.init_slstm}[mixer]
    jfwd = {"mlstm": jxlstm.mlstm_forward, "slstm": jxlstm.slstm_forward}[mixer]
    fwd = {"mlstm": xlstm.mlstm_forward, "slstm": xlstm.slstm_forward}[mixer]
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jp = init(jcfg, jax.random.key(1))
    want = jax.grad(lambda p, x: jnp.sum(jfwd(jcfg, p, x) * w), argnums=(0, 1))(
        jp, jnp.asarray(x))
    params = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = tree.leaves(params) + [torch.from_numpy(x)]
    for t in leaves:
        t.requires_grad_(True)
    out = (fwd(cfg, params, leaves[-1]) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(out, leaves)
    for a, b in zip(got, jax.tree.leaves(want[0]) + [want[1]]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_stacked_leaf_gradient_is_stacked_once():
    """Under autograd the stack takes its group views with one ``unbind``
    per stacked leaf, whose backward stacks the group gradients once (a
    select per group would allocate a zero tensor the size of the whole
    leaf for every group)."""
    cfg = get_config("yi_6b").reduced()
    params = from_jax(jax.tree.map(np.asarray, _jparams("yi_6b")), device="cpu")
    w1 = params["layers"][0]["mlp"]["w1"].requires_grad_(True)
    loss, _ = Model(cfg, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    consumers, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is not None and getattr(nxt, "variable", None) is w1:
                consumers.append(type(fn).__name__)
            todo.append(nxt)
    assert consumers == ["UnbindBackward0"], consumers
    (g,) = torch.autograd.grad(loss, [w1])
    assert g.shape == w1.shape


def test_train_raises_without_a_card():
    """``train()`` defaults to the card and raises with none present."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.launch import train

    cfg = get_config("yi_6b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, train.TrainOptions(steps=1, batch=2, seq=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])
    # a mesh needs a process group the caller initialised (launch/mesh.py)
    with pytest.raises(RuntimeError, match="process group"):
        train.train(cfg, train.TrainOptions(steps=1, mesh_shape=(2, 1), device="cpu"))

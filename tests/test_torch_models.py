"""The port's reduced models held against the reference model on converted
weights (yi-6b, and as parametrised cases the MoE qwen3-moe and llama4, the
attention/mamba/MoE hybrid jamba, the dense nemotron-4-15b, qwen2.5-14b and
stablelm-3b, the xLSTM stack xlstm-1.3b, the encoder-decoder
whisper-large-v3 and the vision-prefixed internvl2-1b), plus the port's
isolation from jax and from ``repro``.

Tolerance: ``TOL``, f32 on both sides; the xLSTM stack, which amplifies
rounding at a few ill-conditioned positions, holds to ``STACK_TOL``
(argued in test_torch_xlstm.py, where each xLSTM mixer holds to TOL)."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config
from repro_torch.models.model import Model
from repro_torch.weights import from_jax
from test_torch_xlstm import STACK_TOL

TOL = dict(atol=1e-4, rtol=1e-4)  # f32 on both sides: summation order only
RNG = np.random.default_rng(3)
SRC = Path(__file__).resolve().parents[1] / "src"
# the architectures ported after yi-6b: every block pattern the port serves
NEW_ARCHS = ("qwen3_moe_235b_a22b", "jamba_v01_52b", "llama4_maverick_400b_a17b")
# the dense decoders with layernorm (nemotron, stablelm), the squared-ReLU MLP
# (nemotron) and QKV bias (qwen2.5)
DENSE_ARCHS = ("nemotron_4_15b", "qwen25_14b", "stablelm_3b")
# the xLSTM stack, the encoder-decoder (fed stub frames) and the vision
# prefix (fed stub patches)
LATE_ARCHS = ("xlstm_13b", "whisper_large_v3", "internvl2_1b")


def nonzero_norms_and_biases(jparams, seed: int = 11):
    """The reference tree with every norm leaf (``norm*``: ``w``, and
    layernorm's ``b``) and every QKV bias (``bq/bk/bv``) redrawn from a
    numpy seed: the reference initialises them to ones and zeros, values at
    which a port that never added a bias or a shift would still agree."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("bq", "bk", "bv") or any(
                isinstance(k, str) and k.startswith("norm") for k in keys):
            draw = rng.standard_normal(leaf.shape) * 0.5
            return jnp.asarray(draw + (1.0 if keys[-1] == "w" else 0.0), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, jparams)


def _make_pair(arch, jcfg=None, cfg=None):
    jcfg = jcfg or jget_config(arch).reduced()
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    if arch in DENSE_ARCHS:
        jparams = nonzero_norms_and_biases(jparams)
    model = Model(cfg or get_config(arch).reduced(), device="cpu")
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def pair():
    return _make_pair("yi_6b")


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_pair(request):
    return _make_pair(request.param)


@pytest.fixture(scope="module", params=LATE_ARCHS)
def late_pair(request):
    return _make_pair(request.param)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_pair(request):
    """A dense arch on reference weights whose norms and QKV biases were
    redrawn nonzero (``nonzero_norms_and_biases``)."""
    return _make_pair(request.param)


def _tokens(b, s, vocab=256):
    return RNG.integers(0, vocab, (b, s)).astype(np.int32)


def _batches(cfg, toks):
    """Tokens [B, S] -> (the port's batch, the reference's), with stub
    frames or patches, 0.1 N(0, 1) from the numpy seed as
    tests/test_models.py draws them, where the arch has a frontend."""
    batch = {"tokens": toks}
    if cfg.frontend:
        key = "frames" if cfg.frontend == "audio" else "patches"
        batch[key] = (0.1 * RNG.standard_normal(
            (toks.shape[0], cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


def _prefix(cfg):
    """Positions the vision prefix takes before the tokens."""
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


def _tol(cfg):
    return STACK_TOL if cfg.family == "ssm" else TOL


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _close_cache(cache, jcache, tol=TOL):
    leaves = [d[key] for d in cache for key in sorted(d)]
    jleaves = [d[key] for d in jcache for key in sorted(d)]
    assert len(leaves) == len(jleaves) == len(jax.tree.leaves(jcache))
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def test_init_matches_reference_tree(pair):
    """``Model.init`` draws the reference's tree: same keys, shapes, dtypes."""
    _check_init_tree(pair)


def _check_init_tree(pair):
    jmodel, jparams, model, params = pair
    mine = model.init(torch.Generator().manual_seed(0))
    flat = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(jparams)}
    conv = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(
                jax.tree.map(lambda t: np.empty(t.shape), mine,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)))}
    assert conv == flat
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        mine, is_leaf=lambda t: isinstance(t, torch.Tensor)))


def test_from_jax_keeps_bf16_and_tree_shape():
    """bf16 leaves (numpy has no bf16) arrive as exact torch bf16 tensors;
    dicts stay dicts and tuples stay tuples."""
    a = np.asarray(jnp.asarray(RNG.standard_normal((3, 4)), jnp.bfloat16))
    t = from_jax({"w": a, "stack": [{"b": a}]}, device="cpu")
    assert t["w"].dtype == torch.bfloat16 and isinstance(t["stack"], tuple)
    np.testing.assert_array_equal(t["stack"][0]["b"].float().numpy(),
                                  a.astype(np.float32))


def test_logits_match(pair):
    _check_logits(pair)


def _check_logits(pair):
    jmodel, jparams, model, params = pair
    batch, jbatch = _batches(model.cfg, _tokens(2, 12))
    got = model.logits(params, batch)
    want = jmodel.logits(jparams, jbatch)
    assert tuple(got.shape) == want.shape == (2, 12, model.cfg.vocab)
    _close(got, want, _tol(model.cfg))


@pytest.mark.parametrize("b,s,cap", [(1, 7, 12), (2, 12, 16)])
def test_prefill_matches(pair, b, s, cap):
    _check_prefill(pair, b, s, cap)


def _check_prefill(pair, b, s, cap):
    """``cap`` counts the prompt's positions; the vision prefix's are added."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    batch, jbatch = _batches(cfg, _tokens(b, s))
    cap += _prefix(cfg)
    cache, pos, last = model.prefill(params, batch, cap)
    jcache, jpos, jlast = jmodel.prefill(jparams, jbatch, cap)
    assert int(pos) == int(jpos) == s + _prefix(cfg)
    _close(last, jlast, _tol(cfg))
    _close_cache(cache, jcache, _tol(cfg))


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches(pair, vector):
    _check_decode_step(pair, vector)


def _check_decode_step(pair, vector, s=8):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    b, cap = 3, s + 4 + _prefix(cfg)
    batch, jbatch = _batches(cfg, _tokens(b, s))
    cache, _, _ = model.prefill(params, batch, cap)
    jcache, _, _ = jmodel.prefill(jparams, jbatch, cap)
    new = _tokens(1, b)[0]
    pos = np.array([2, 7, 0], np.int32) if vector else np.int32(s + _prefix(cfg))
    got, cache = model.decode_step(params, cache, torch.from_numpy(new),
                                   torch.tensor(pos))
    want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(new),
                                      jnp.asarray(pos))
    _close(got, want, _tol(cfg))
    _close_cache(cache, jcache, _tol(cfg))


def test_init_matches_reference_tree_new_archs(arch_pair):
    """The MoE (``router``, ``w1/w2/w3`` ``[G, E, ...]``, ``shared``) and
    Mamba trees, per pattern position."""
    _check_init_tree(arch_pair)


def test_logits_match_new_archs(arch_pair):
    _check_logits(arch_pair)


@pytest.mark.parametrize("b,s,cap", [(1, 7, 12), (2, 12, 16)])
def test_prefill_matches_new_archs(arch_pair, b, s, cap):
    """Last logits and every cache leaf: attention k/v and mamba
    ``{conv, h}``."""
    _check_prefill(arch_pair, b, s, cap)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches_new_archs(arch_pair, vector):
    _check_decode_step(arch_pair, vector)


def test_stack_aux_loss_matches_reference(arch_pair):
    """``apply_stack`` returns the summed MoE aux loss where the reference
    does, with the hidden state."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T

    jmodel, jparams, model, params = arch_pair
    x = RNG.standard_normal((2, 10, model.cfg.d_model)).astype(np.float32)
    pos = np.arange(10)
    y, aux = T.apply_stack(model.cfg, params["layers"], torch.from_numpy(x),
                           torch.from_numpy(pos))
    jy, _, jaux = JT.apply_stack(jmodel.cfg, jparams["layers"], jnp.asarray(x),
                                 jnp.asarray(pos))
    _close(y, jy)
    _close(aux, jaux)
    assert float(aux) > 0


def test_init_matches_reference_tree_late_archs(late_pair):
    """The mLSTM and sLSTM trees; the encoder (``encoder``, ``enc_norm_f``,
    ``enc_pos``) and each decoder block's cross-attention (``norm_x``,
    ``xattn``); ``vis_proj``."""
    _check_init_tree(late_pair)
    cfg = late_pair[2].cfg
    mine = late_pair[2].init(torch.Generator().manual_seed(0))
    assert ("encoder" in mine) == ("xattn" in mine["layers"][0]) == cfg.encoder_decoder
    assert ("vis_proj" in mine) == (cfg.frontend == "vision")


def test_logits_match_late_archs(late_pair):
    _check_logits(late_pair)


@pytest.mark.parametrize("b,s,cap", [(1, 7, 12), (2, 12, 16)])
def test_prefill_matches_late_archs(late_pair, b, s, cap):
    """Last logits and every cache leaf: mLSTM ``{C, n, m}``, sLSTM ``{c,
    n, h, m}``, the encoder's ``{xk, xv}`` written whole, k/v after the
    vision prefix."""
    _check_prefill(late_pair, b, s, cap)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches_late_archs(late_pair, vector):
    """At S=9: at S=8, reduced whisper's frame count, the reference's
    prefill pads the cross-attention cache as if it were k/v (pinned by
    ``test_reference_decodes_wrong_at_prompt_length_equal_to_frame_count``)."""
    _check_decode_step(late_pair, vector, s=9)


@functools.lru_cache(maxsize=None)
def _whisper_pair():
    return _make_pair("whisper_large_v3")


def test_reference_decodes_wrong_at_prompt_length_equal_to_frame_count():
    """Reduced whisper, S = n_frontend_tokens = 8, cap 12: the reference's
    ``prefill`` pads every 5-d cache leaf whose axis 3 is S, so the
    cross-attention's ``xk``/``xv`` [G, B, Hkv, 8, dh] grow to cap
    positions and its decode attends over 4 zero keys: its logits leave its
    own full forward's, with no error. The port writes ``xk``/``xv`` whole
    by key and decodes to the full forward's logits."""
    jmodel, jparams, model, params = _whisper_pair()
    s, cap = model.cfg.n_frontend_tokens, 12
    batch, jbatch = _batches(model.cfg, _tokens(1, s + 1))
    want = jmodel.logits(jparams, jbatch)[:, s]
    head = lambda bt: {**bt, "tokens": bt["tokens"][:, :s]}
    jcache, jpos, _ = jmodel.prefill(jparams, head(jbatch), cap)
    assert jcache[0]["xk"].shape[3] == cap
    jgot, _ = jmodel.decode_step(jparams, jcache, jbatch["tokens"][:, s], jpos)
    assert np.abs(np.asarray(jgot) - np.asarray(want)).max() > 0.05
    cache, pos, _ = model.prefill(params, head(batch), cap)
    assert cache[0]["xk"].shape[3] == s
    got, _ = model.decode_step(params, cache, batch["tokens"][:, s], pos)
    _close(got, want)


def test_whisper_encoder_runs_non_causal_attention_through_the_kernel_path(monkeypatch):
    """The encoder's self-attention is non-causal and goes through
    ``ops.attention`` (the flash kernel on the card); the decoder's is
    causal through the same path; cross-attention takes the chunked plain
    path, as in the reference."""
    from repro_torch.models import attention as tattn

    model, params = _whisper_pair()[2:]
    calls, chunked = [], []
    kernel, plain = tattn.kops.attention, tattn.chunked_attention
    monkeypatch.setattr(tattn.kops, "attention",
                        lambda q, k, v, **kw: calls.append((q.shape[2], kw["causal"]))
                        or kernel(q, k, v, **kw))
    monkeypatch.setattr(tattn, "chunked_attention",
                        lambda q, k, v, **kw: chunked.append(k.shape[2]) or plain(q, k, v, **kw))
    batch, _ = _batches(model.cfg, _tokens(1, 5))
    model.prefill(params, batch, 8)
    cfg = model.cfg
    assert calls == ([(cfg.n_frontend_tokens, False)] * cfg.n_encoder_layers
                     + [(5, True)] * cfg.n_layers)
    assert chunked == [cfg.n_frontend_tokens] * cfg.n_layers


def test_init_matches_reference_tree_dense_archs(dense_pair):
    """Layernorm's ``{w, b}``, the squared-ReLU MLP without ``w3`` and the
    QKV biases ``bq/bk/bv`` (``from_jax`` copies them leaf by leaf)."""
    _check_init_tree(dense_pair)
    _, jparams, model, params = dense_pair
    mine = model.init(torch.Generator().manual_seed(0))
    cfg = model.cfg
    layer = mine["layers"][0]
    assert ("b" in layer["norm1"]) == ("b" in mine["norm_f"]) == (cfg.norm == "layernorm")
    assert ("w3" in layer["mlp"]) == (cfg.activation == "swiglu")
    assert ("bq" in layer["mixer"]) == cfg.qkv_bias
    # the reference's initial values, before the tests redraw them
    assert torch.equal(layer["norm1"]["w"], torch.ones_like(layer["norm1"]["w"]))
    for key in ("b", "bq", "bk", "bv"):
        for leaf in (layer["norm1"].get(key), layer["mixer"].get(key)):
            assert leaf is None or not leaf.any()
    # the converted leaves are the redrawn ones
    jl = jparams["layers"][0]
    for key, leaf in list(params["layers"][0]["norm1"].items()) + [
            (k, v) for k, v in params["layers"][0]["mixer"].items() if k.startswith("b")]:
        src = jl["norm1"] if key in ("w", "b") else jl["mixer"]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(src[key]))
        assert leaf.abs().min() > 0 or key == "w"


def test_logits_match_dense_archs(dense_pair):
    _check_logits(dense_pair)


@pytest.mark.parametrize("b,s,cap", [(1, 7, 12), (2, 12, 16)])
def test_prefill_matches_dense_archs(dense_pair, b, s, cap):
    _check_prefill(dense_pair, b, s, cap)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches_dense_archs(dense_pair, vector):
    _check_decode_step(dense_pair, vector)


@pytest.mark.parametrize("arch,path", [
    ("nemotron_4_15b", ("layers", 0, "norm2", "b")),
    ("nemotron_4_15b", ("norm_f", "b")),
    ("qwen25_14b", ("layers", 0, "mixer", "bq")),
    ("qwen25_14b", ("layers", 0, "mixer", "bk")),
    ("qwen25_14b", ("layers", 0, "mixer", "bv")),
    ("stablelm_3b", ("layers", 0, "norm1", "b")),
])
def test_parity_catches_an_ignored_bias(arch, path):
    """Zeroing one bias or layernorm shift on the port's side only, as a port
    that never added it would behave, breaks the logits' parity: the
    redrawn leaves are not at values that hide it."""
    jmodel, jparams, model, params = _make_pair(arch)
    _check_logits((jmodel, jparams, model, params))
    node = params
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = torch.zeros_like(node[path[-1]])
    with pytest.raises(AssertionError):
        _check_logits((jmodel, jparams, model, params))


def _widened_stablelm(cfg):
    """Reduced stablelm-3b at head dim 80, the full config's (d_model 2560
    over 32 heads): d_model 160 over 2 heads."""
    return dataclasses.replace(cfg, d_model=160, n_heads=2, n_kv_heads=2, d_head=80)


@pytest.fixture(scope="module")
def head_dim_80_pair():
    return _make_pair("stablelm_3b",
                      jcfg=_widened_stablelm(jget_config("stablelm_3b").reduced()),
                      cfg=_widened_stablelm(get_config("stablelm_3b").reduced()))


@pytest.mark.parametrize("b,s,cap", [(1, 7, 12), (2, 12, 16)])
def test_prefill_matches_at_head_dim_80(head_dim_80_pair, b, s, cap):
    """Prefill attention at head dim 80 (the flash kernel's plain version on
    the CPU), last logits and the k/v cache."""
    assert head_dim_80_pair[2].cfg.head_dim == 80
    _check_prefill(head_dim_80_pair, b, s, cap)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches_at_head_dim_80(head_dim_80_pair, vector):
    _check_decode_step(head_dim_80_pair, vector)


# bf16 against f32 with every MoE layer's routing pinned to the f32
# reference's: the port's max |bf16 - f32| logit error may be at most this
# multiple of the reference's own. Both run the same function in bf16 but
# round at other places (the port casts where torch's kernels do, the
# reference where XLA's do), so their errors have the same size and
# neither bounds the other; twice the reference's own error leaves room
# for that without passing a port whose bf16 path lost a cast or a term.
BF16_ERR_MULTIPLE = 2.0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_bf16_error_within_reference_own_with_routing_pinned(arch, monkeypatch):
    """In bf16 an ulp moves a near-tie top-k set, so the MoE archs are
    compared with routing pinned, as chip_smoke.py pins it: the f32
    reference (run eagerly, so that each MoE layer's routing is concrete)
    records its top-k experts per layer; the bf16 reference and the bf16
    port take those experts with gates from their own router
    probabilities."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat_stack=False)
    jparams = JModel(jcfg).init(jax.random.key(0))
    to16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg16 = dataclasses.replace(jcfg, **to16)
    jparams16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    cfg16 = dataclasses.replace(get_config(arch).reduced(), **to16)
    params16 = from_jax(jax.tree.map(np.asarray, jparams16), device="cpu")
    toks = _tokens(2, 16)

    routes = []
    jroute = jmoe.route

    def record(cfg, p, x):
        out = jroute(cfg, p, x)
        routes.append(np.asarray(out[0]))
        return out

    def pinned_jax():
        it = iter(routes)

        def pin(cfg, p, x):
            idx, (_, _, aux) = jnp.asarray(next(it)), jroute(cfg, p, x)
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"].astype(jnp.float32), -1)
            g = jnp.take_along_axis(probs, idx, -1)
            return idx, (g / jnp.maximum(g.sum(-1, keepdims=True), 1e-9)).astype(x.dtype), aux
        return pin

    troute = tmoe.route

    def pinned_torch():
        it = iter(routes)

        def pin(cfg, p, x):
            idx, (_, _, aux) = torch.tensor(next(it)).long(), troute(cfg, p, x)
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
            g = probs.gather(-1, idx)
            return idx, (g / g.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype), aux
        return pin

    with jax.disable_jit():
        monkeypatch.setattr(jmoe, "route", record)
        want = np.asarray(JModel(jcfg).logits(jparams, {"tokens": jnp.asarray(toks)}),
                          np.float32)
        monkeypatch.setattr(jmoe, "route", pinned_jax())
        ref16 = np.asarray(JModel(jcfg16).logits(
            jparams16, {"tokens": jnp.asarray(toks)}).astype(jnp.float32))
    monkeypatch.setattr(tmoe, "route", pinned_torch())
    got = Model(cfg16, device="cpu").logits(params16, {"tokens": torch.from_numpy(toks)})
    n_moe = sum(jcfg.mlp_kind(i) == "moe" for i in range(jcfg.n_layers))
    assert len(routes) == n_moe > 0
    assert got.dtype == torch.bfloat16
    err_port = float(np.abs(got.float().numpy() - want).max())
    err_ref = float(np.abs(ref16 - want).max())
    assert 0 < err_ref and np.isfinite(err_port)
    assert err_port <= BF16_ERR_MULTIPLE * err_ref, (err_port, err_ref)


@pytest.mark.parametrize("arch", LATE_ARCHS)
def test_bf16_error_within_reference_own_late_archs(arch):
    """The xLSTM stack, the encoder-decoder (stub frames) and the vision
    prefix (stub patches) in bf16 against the f32 reference, which has no
    routing to pin: the port's max |bf16 - f32| logit error is at most
    ``BF16_ERR_MULTIPLE`` times the reference's own."""
    jcfg = jget_config(arch).reduced()
    jparams = JModel(jcfg).init(jax.random.key(0))
    to16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    cfg16 = dataclasses.replace(get_config(arch).reduced(), **to16)
    params16 = from_jax(jax.tree.map(np.asarray, jparams16), device="cpu")
    batch, jbatch = _batches(cfg16, _tokens(2, 16))
    want = np.asarray(JModel(jcfg).logits(jparams, jbatch), np.float32)
    ref16 = np.asarray(JModel(dataclasses.replace(jcfg, **to16)).logits(
        jparams16, jbatch).astype(jnp.float32))
    got = Model(cfg16, device="cpu").logits(params16, batch)
    assert got.dtype == torch.bfloat16
    err_port = float(np.abs(got.float().numpy() - want).max())
    err_ref = float(np.abs(ref16 - want).max())
    assert 0 < err_ref and np.isfinite(err_port)
    assert err_port <= BF16_ERR_MULTIPLE * err_ref, (err_port, err_ref)


def test_moe_prefill_with_drops_matches_reference():
    """Reduced qwen3-moe at capacity factor 0.25 (most assignments dropped,
    slot (0, 0) emptied as the reference empties it)."""
    jcfg = jget_config("qwen3_moe_235b_a22b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.25))
    cfg = get_config("qwen3_moe_235b_a22b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    pair = (jmodel, jparams, Model(cfg, device="cpu"),
            from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    _check_prefill(pair, 2, 16, 20)
    _check_decode_step(pair, True)


def test_decode_step_rejects_position_past_cache(pair):
    _, _, model, params = pair
    cache = model.init_cache(1, 4)
    with pytest.raises(ValueError):
        model.decode_step(params, cache, torch.tensor([1]), torch.tensor(4))


def test_long_prompt_takes_chunked_path(pair, monkeypatch):
    """At or above the threshold prefill goes to ``chunked_attention`` and
    still matches the reference."""
    from repro_torch.models import attention as tattn
    from repro.models import attention as jattn

    jmodel, jparams, model, params = pair
    calls = []
    orig = tattn.chunked_attention
    monkeypatch.setattr(tattn, "chunked_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    cfg = model.cfg
    h = torch.from_numpy(RNG.standard_normal((1, 16, cfg.d_model)).astype(np.float32))
    p = {k: v[0] for k, v in params["layers"][0]["mixer"].items()}
    jp = {k: v[0] for k, v in jparams["layers"][0]["mixer"].items()}
    pos = np.arange(16)
    y, _ = tattn.attention_forward(cfg, p, h, torch.from_numpy(pos),
                                   chunked_threshold=16)
    jy, _ = jattn.attention_forward(jmodel.cfg, jp, jnp.asarray(h.numpy()),
                                    jnp.asarray(pos), chunked_threshold=16)
    assert calls == [1]
    _close(y, jy)


# --------------------------------------------------------------------------
# isolation, device defaults, config parity
# --------------------------------------------------------------------------


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port (the schedule store, the zoo
    families, the training path, the targets, the calibration, the
    learned ranker, the multi-device modules, the dry run, the fleet
    controller and the examples included; none starts a process group or
    does any work), then registering its op families, parsing HLO text for
    the learned ranker's columns, running the
    static matmul and flash picks and featurizing the zoo families on every
    target, loads no jax and no ``repro`` module (a subprocess: this test process has jax loaded
    already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from repro_torch.core import op_registry, tuner\n"
        "op_registry.families()  # the lazy import of the op families\n"
        "tuner.tuned_matmul_blocks(2048, 4096, 4096)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "assert len(mods) >= 15, mods\n"
        "want = {'repro_torch.core.zoo', 'repro_torch.configs.tuna_ops', "
        "'repro_torch.models.xlstm'} | {'repro_torch.configs.' + m for m in "
        "('xlstm_13b', 'whisper_large_v3', 'internvl2_1b')} | "
        "{'repro_torch.tuna.' + m for m in ('db', 'cache', 'transport', "
        "'orchestrator', 'fleet', 'cli', '__main__')} | "
        "{'repro_torch.' + m for m in ('tree', 'optim.adamw', 'optim.schedule', "
        "'parallel.collectives', 'launch.steps', 'launch.train', 'data.synthetic', "
        "'data.loader', 'runtime.failure', 'runtime.straggler', "
        "'checkpoint.store', 'core.calibrate', 'core.learned', 'tuna.learned', "
        "'hw.tpu_v5e', 'hw.cpu_avx2', 'hw.gpu_a100', 'launch.mesh', 'launch.specs', "
        "'parallel.sharding', 'parallel.context', 'parallel.pipeline', "
        "'checkpoint.elastic', 'core.hlo_features', 'core.sharding_tuner', "
        "'launch.dryrun', 'tuna.controller', 'examples.quickstart', "
        "'examples.serve_batched', 'examples.train_tiny', 'examples.tune_operator')}\n"
        "assert want <= set(mods), sorted(want - set(mods))\n"
        "from repro_torch.kernels import ops\n"
        "ops.tuned_flash_blocks(77, 80)  # the flash family's signature\n"
        "from repro_torch.core import calibrate, learned\n"
        "from repro_torch.hw import TARGET_NAMES, get_target\n"
        "for t in TARGET_NAMES:  # the zoo families on every target\n"
        "    for fam in ('moe_dispatch', 'ssm_scan', 'mlstm_chunk'):\n"
        "        _, pre = next(v for v in op_registry.all_presets().values() "
        "if v[0] == fam)\n"
        "        sp = op_registry.make_space(fam, pre.attrs, get_target(t).kind)\n"
        "        learned.featurize(sp, get_target(t), sp.default_config())\n"
        "calibrate.coeffs_for_scoring(dict.fromkeys(calibrate.FEATURES, 1e-9))\n"
        "assert learned.hlo_counts('%f = f32[4]{0} fusion(%x), kind=kLoop') == "
        "(1.0, 0.0, 0.0, 0.0)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # importing a mesh module starts no group\n"
        "print(len(mods)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_the_card(pair):
    """Without ``device=`` the port runs on the card; with no card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.launch import serve

    jparams = pair[1]
    cfg = get_config("yi_6b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax(jax.tree.map(np.asarray, jparams))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-6b", "--reduced"])


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    mine, ref = get_config("yi-6b"), jget_config("yi-6b")
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.pattern() == ref.pattern()
    assert mine.head_dim == ref.head_dim
    assert mine.param_count() == ref.param_count()
    assert mine.torch_compute_dtype() == getattr(torch, ref.compute_dtype)


@pytest.mark.parametrize("arch", NEW_ARCHS + DENSE_ARCHS + LATE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference_new_archs(arch, reduced):
    """Fields, pattern and parameter counts (total and active) of the MoE,
    hybrid, later dense, xLSTM, encoder-decoder and vision configs; the
    aliases resolve to the same config."""
    mine, ref = get_config(arch), jget_config(arch)
    assert get_config(ref.name) == mine
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.pattern() == ref.pattern()
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()


def test_unknown_mixer_kind_raises():
    """A block pattern with a mixer the reference does not have is refused,
    not run as something else."""
    cfg = dataclasses.replace(get_config("yi_6b").reduced(), default_mixer="retnet")
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="retnet"):
        model.init_cache(1, 8)


def test_unknown_activation_raises():
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("whisper_large_v3").reduced(), activation="relu6")
    with pytest.raises(ValueError, match="relu6"):
        Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="relu6"):
        L._act(cfg, torch.zeros(2), None)


@pytest.mark.parametrize("name", ["gpt2", "xlstm-7b", "whisper_large_v2"])
def test_arch_outside_the_registry_is_refused(name):
    with pytest.raises(ValueError, match="unknown arch"):
        get_config(name)


def test_registry_holds_every_reference_arch():
    """``get_config`` accepts all ten of the reference's ``ARCH_IDS``, by id
    and by published name."""
    from repro.configs.base import ARCH_IDS as REF_IDS
    from repro_torch.configs.base import ARCH_IDS

    assert sorted(ARCH_IDS) == sorted(REF_IDS) and len(ARCH_IDS) == 10
    for arch in REF_IDS:
        assert get_config(arch) == get_config(jget_config(arch).name)

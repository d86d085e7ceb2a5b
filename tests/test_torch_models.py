"""The port's reduced models held against the reference model on converted
weights (yi-6b, and as parametrised cases the MoE qwen3-moe and llama4 and
the attention/mamba/MoE hybrid jamba), plus the port's isolation from jax
and from ``repro``."""
import dataclasses
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

TOL = dict(atol=1e-4, rtol=1e-4)  # f32 on both sides: summation order only
RNG = np.random.default_rng(3)
SRC = Path(__file__).resolve().parents[1] / "src"
# the architectures ported after yi-6b: every block pattern the port serves
NEW_ARCHS = ("qwen3_moe_235b_a22b", "jamba_v01_52b", "llama4_maverick_400b_a17b")


def _make_pair(arch):
    jcfg = jget_config(arch).reduced()
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = Model(get_config(arch).reduced(), device="cpu")
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def pair():
    return _make_pair("yi_6b")


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_pair(request):
    return _make_pair(request.param)


def _tokens(b, s, vocab=256):
    return RNG.integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL)


def _close_cache(cache, jcache):
    leaves = [d[key] for d in cache for key in sorted(d)]
    jleaves = [d[key] for d in jcache for key in sorted(d)]
    assert len(leaves) == len(jleaves) == len(jax.tree.leaves(jcache))
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == b.shape
        _close(a, b)


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
    toks = _tokens(2, 12)
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    _close(got, want)


@pytest.mark.parametrize("b,s,cap", [(1, 7, 12), (2, 12, 16)])
def test_prefill_matches(pair, b, s, cap):
    _check_prefill(pair, b, s, cap)


def _check_prefill(pair, b, s, cap):
    jmodel, jparams, model, params = pair
    toks = _tokens(b, s)
    cache, pos, last = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                     cap)
    jcache, jpos, jlast = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                         cap)
    assert int(pos) == int(jpos) == s
    _close(last, jlast)
    _close_cache(cache, jcache)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches(pair, vector):
    _check_decode_step(pair, vector)


def _check_decode_step(pair, vector):
    jmodel, jparams, model, params = pair
    b, s, cap = 3, 8, 12
    toks = _tokens(b, s)
    cache, _, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cap)
    jcache, _, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cap)
    new = _tokens(1, b)[0]
    pos = np.array([2, 7, 0], np.int32) if vector else np.int32(s)
    got, cache = model.decode_step(params, cache, torch.from_numpy(new),
                                   torch.tensor(pos))
    want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(new),
                                      jnp.asarray(pos))
    _close(got, want)
    _close_cache(cache, jcache)


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
    """Importing every module of the port, then registering its op families
    and running the static matmul pick, loads no jax and no ``repro`` module
    (a subprocess: this test process has jax loaded already)."""
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


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference_new_archs(arch, reduced):
    """Fields, pattern and parameter counts (total and active) of the MoE
    and hybrid configs; the aliases resolve to the same config."""
    mine, ref = get_config(arch), jget_config(arch)
    assert get_config(ref.name) == mine
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.pattern() == ref.pattern()
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("change", [dict(slstm_every=2, slstm_offset=1),
                                    dict(encoder_decoder=True, n_encoder_layers=2)])
def test_unported_blocks_raise(change):
    """The xLSTM mixers and cross-attention come with later slices: a
    pattern that needs them is refused, not run as something else."""
    cfg = dataclasses.replace(get_config("yi_6b").reduced(), **change)
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        model.init_cache(1, 8)


def test_unported_config_is_refused():
    with pytest.raises(ValueError):
        get_config("xlstm_13b")

"""The port's xLSTM mixers (``repro_torch.models.xlstm``) held against the
reference's on seeded numpy inputs and converted weights, in f32 (reduced
xlstm-1.3b: d_model 64, 4 heads, mLSTM head dim 32, chunk 8); the port's
copies of the reference's own xLSTM oracles; and the prompt length equal to
the mLSTM head dim, where the reference's ``prefill`` pads the mLSTM memory
by its shape and its first decode step raises (ROADMAP Queue C), while the
port places each cache leaf by its key.

Tolerances: the mixers, f32 on both sides, differ only in the order of
summation (and in the last ulp of ``exp`` and ``log_sigmoid``): ``TOL``,
1e-4 absolute and relative, as in test_torch_models.py; they agree to about
1e-6. The whole reduced stack (16 layers) amplifies rounding far more than
one mixer, and most at a few ill-conditioned positions: a one-ulp relative
perturbation of the embedding table moves its logits by up to 1.7e-3 at
S=12 and 7.1e-3 at S=31 (three seeds each), and at S=32 the reference's own
scanned and eager forwards differ by 0.055 at one logit, where the port
differs from the scanned one by 0.11. The reference holds its own xLSTM
decode to its full forward within 0.25 absolute and 0.05 relative
(``tests/test_models.py`` ``DECODE_TOL``). A comparison through the whole
stack holds to ``STACK_TOL``, 5e-2 absolute and relative (five times
tighter in absolute terms), while each mixer holds to TOL.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import xlstm as jxlstm
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config
from repro_torch.models import xlstm
from repro_torch.models.model import Model
from repro_torch.weights import from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
STACK_TOL = dict(atol=5e-2, rtol=5e-2)
CFG, JCFG = get_config("xlstm_13b").reduced(), jget_config("xlstm_13b").reduced()
ORACLE_RNG = np.random.default_rng(0)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _x(b, s, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, s, CFG.d_model))).astype(np.float32)


def _params(init, seed=0):
    jp = init(JCFG, jax.random.key(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _close_state(state, jstate):
    assert set(state) == set(jstate)
    for key in state:
        assert tuple(state[key].shape) == jstate[key].shape, key
        _close(state[key], jstate[key])


# --------------------------------------------------------------------------
# the mixers against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,r", [(16, 8), (12, 4), (13, 1)])
def test_mlstm_forward_matches_reference(s, r, monkeypatch):
    """Output and final state ``{C, n, m}``; the chunk is the reference's
    rule (``min(mlstm_chunk, S)`` halved until it divides S), counted."""
    assert CFG.mlstm_chunk == 8 and xlstm.m_dims(CFG) == (128, 32)
    jp, p = _params(jxlstm.init_mlstm)
    x = _x(2, s, seed=s)
    chunks = []
    orig = xlstm._mlstm_chunk
    monkeypatch.setattr(xlstm, "_mlstm_chunk",
                        lambda q, *a: chunks.append(q.shape[2]) or orig(q, *a))
    y, state = xlstm.mlstm_forward(CFG, p, torch.from_numpy(x), return_state=True)
    jy, jstate = jxlstm.mlstm_forward(JCFG, jp, jnp.asarray(x), return_state=True)
    assert chunks == [r] * (s // r)
    _close(y, jy)
    _close_state(state, jstate)


def test_mlstm_decode_matches_reference():
    """Eight tokens stepped from the initial cache: each step's output and
    state."""
    jp, p = _params(jxlstm.init_mlstm, seed=1)
    x = _x(3, 8, seed=4)
    cache = xlstm.init_mlstm_cache(CFG, 3, "cpu")
    jcache = jxlstm.init_mlstm_cache(JCFG, 3)
    _close_state(cache, jcache)
    for t in range(8):
        y, cache = xlstm.mlstm_decode(CFG, p, torch.from_numpy(x[:, t:t + 1]), cache)
        jy, jcache = jxlstm.mlstm_decode(JCFG, jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(y, jy)
        _close_state(cache, jcache)


def test_slstm_forward_matches_reference():
    jp, p = _params(jxlstm.init_slstm)
    x = _x(2, 16, seed=5)
    y, state = xlstm.slstm_forward(CFG, p, torch.from_numpy(x), return_state=True)
    jy, jstate = jxlstm.slstm_forward(JCFG, jp, jnp.asarray(x), return_state=True)
    _close(y, jy)
    _close_state(state, jstate)


def test_slstm_decode_matches_reference():
    jp, p = _params(jxlstm.init_slstm, seed=1)
    x = _x(3, 8, seed=6)
    cache = xlstm.init_slstm_cache(CFG, 3, "cpu")
    jcache = jxlstm.init_slstm_cache(JCFG, 3)
    _close_state(cache, jcache)
    for t in range(8):
        y, cache = xlstm.slstm_decode(CFG, p, torch.from_numpy(x[:, t:t + 1]), cache)
        jy, jcache = jxlstm.slstm_decode(JCFG, jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(y, jy)
        _close_state(cache, jcache)


@pytest.mark.parametrize("init,jinit", [(xlstm.init_mlstm, jxlstm.init_mlstm),
                                        (xlstm.init_slstm, jxlstm.init_slstm)])
def test_init_matches_reference_tree(init, jinit):
    """Keys, shapes and dtypes; the constant leaves (forget-gate biases,
    the mLSTM's output scale) equal the reference's."""
    mine = init(CFG, torch.Generator().manual_seed(0), (2,))
    ref = jax.vmap(lambda k: jinit(JCFG, k))(jax.random.split(jax.random.key(0), 2))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())
    for key in ("f_bias", "scale", "b"):
        if key in mine:
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(ref[key]))


# --------------------------------------------------------------------------
# the port's copies of tests/test_moe_ssm.py::TestXlstmOracle
# --------------------------------------------------------------------------


def _port_params(init):
    return init(CFG, torch.Generator().manual_seed(0))


def test_mlstm_chunkwise_matches_stepwise():
    p = _port_params(xlstm.init_mlstm)
    b, s = 2, 24
    x = torch.from_numpy((0.5 * ORACLE_RNG.standard_normal((b, s, CFG.d_model)))
                         .astype(np.float32))
    y_par, state = xlstm.mlstm_forward(CFG, p, x, return_state=True)
    cache = xlstm.init_mlstm_cache(CFG, b, "cpu")
    ys = []
    for t in range(s):
        yt, cache = xlstm.mlstm_decode(CFG, p, x[:, t:t + 1], cache)
        ys.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, dim=1).numpy(),
                               atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(state["C"].numpy(), cache["C"].numpy(), atol=5e-4,
                               rtol=5e-3)


def test_slstm_forward_matches_decode():
    p = _port_params(xlstm.init_slstm)
    b, s = 2, 16
    x = torch.from_numpy((0.5 * ORACLE_RNG.standard_normal((b, s, CFG.d_model)))
                         .astype(np.float32))
    y_fwd, _ = xlstm.slstm_forward(CFG, p, x, return_state=True)
    cache = xlstm.init_slstm_cache(CFG, b, "cpu")
    ys = []
    for t in range(s):
        yt, cache = xlstm.slstm_decode(CFG, p, x[:, t:t + 1], cache)
        ys.append(yt)
    np.testing.assert_allclose(y_fwd.numpy(), torch.cat(ys, dim=1).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_mlstm_forget_gate_decay():
    """With a strongly negative forget gate (and the exp input gate
    neutralised), early-token perturbations decay away."""
    p = _port_params(xlstm.init_mlstm)
    p = dict(p, f_bias=torch.full_like(p["f_bias"], -8.0),
             w_i=torch.zeros_like(p["w_i"]))
    x = torch.from_numpy(ORACLE_RNG.standard_normal((1, 32, CFG.d_model))
                         .astype(np.float32))
    x2 = x.clone()
    x2[:, :8] += 1.0  # perturb early tokens only
    y1 = xlstm.mlstm_forward(CFG, p, x)
    y2 = xlstm.mlstm_forward(CFG, p, x2)
    assert float((y1[:, -1] - y2[:, -1]).abs().max()) < 1e-2


# --------------------------------------------------------------------------
# the prompt length equal to the mLSTM head dim
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_pair():
    jmodel = JModel(JCFG)
    jparams = jmodel.init(jax.random.key(0))
    return (jmodel, jparams, Model(CFG, device="cpu"),
            from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))


def _prompt_and_next(s):
    toks = np.random.default_rng(s).integers(0, CFG.vocab, (1, s + 1)).astype(np.int32)
    return toks


def test_reference_decode_raises_at_prompt_length_equal_to_mlstm_head_dim(model_pair):
    """Reduced xlstm, S = dh = 32, cap 40: the reference's ``prefill`` pads
    every 5-d cache leaf whose axis 3 is S, so the mLSTM memory C [G, B, H,
    dh, dh] becomes [G, B, H, cap, dh] and its first decode step raises.
    The port decodes there, to the reference's full-forward logits at
    position 32."""
    jmodel, jparams, model, params = model_pair
    s, cap = 32, 40
    assert xlstm.m_dims(CFG)[1] == s
    toks = _prompt_and_next(s)
    jcache, jpos, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :s])}, cap)
    assert jcache[0]["C"].shape[3] == cap  # the memory padded as if it were k/v
    with pytest.raises(ValueError, match="does not match"):
        jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, s]), jpos)
    cache, pos, _ = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])}, cap)
    assert tuple(cache[0]["C"].shape[3:]) == (s, s)
    got, _ = model.decode_step(params, cache, torch.from_numpy(toks[:, s]), pos)
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})[:, s]
    _close(got, want, **STACK_TOL)


def test_prefill_and_decode_at_prompt_length_one_below_mlstm_head_dim(model_pair):
    """S = 31, cap 40: both packages run. The port's last prefill logits
    and its decode logits match the reference's, and its decode logits the
    reference's full forward."""
    jmodel, jparams, model, params = model_pair
    s, cap = 31, 40
    toks = _prompt_and_next(s)
    jcache, jpos, jlast = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :s])}, cap)
    cache, pos, last = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])}, cap)
    assert int(pos) == int(jpos) == s
    _close(last, jlast, **STACK_TOL)
    want, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, s]), jpos)
    got, _ = model.decode_step(params, cache, torch.from_numpy(toks[:, s]), pos)
    _close(got, want, **STACK_TOL)
    _close(got, jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})[:, s], **STACK_TOL)

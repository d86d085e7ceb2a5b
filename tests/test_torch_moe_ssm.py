"""The port's MoE MLP and Mamba mixer held against the reference on seeded
numpy inputs and converted weights, in f32 (reduced configs).

Tolerance: f32 on both sides, so only the order of summation differs:
1e-4 absolute and relative, as in test_torch_models.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.weights import from_jax

TOL = dict(atol=1e-4, rtol=1e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _cfgs(arch, cf=None):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    return cfg, jcfg


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jcfg, jax.random.key(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(b, s, d, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, s, d))).astype(np.float32)


def _bruteforce_keep(idx, cap):
    """Per row, an assignment is kept iff fewer than ``cap`` earlier
    assignments (token-major, then k) went to its expert."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    keep = np.zeros(flat.shape, bool)
    for r in range(b):
        seen = {}
        for j, e in enumerate(flat[r]):
            keep[r, j] = seen.get(int(e), 0) < cap
            seen[int(e)] = seen.get(int(e), 0) + 1
    return keep


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("router", ["seeded", "zero"])
def test_route_matches_reference(router):
    """idx, gates and the aux loss; with a zero router every expert ties and
    the top k must be the lowest indices, as jax.lax.top_k breaks ties."""
    cfg, jcfg = _cfgs("qwen3_moe_235b_a22b")
    jp, p = _moe_params(jcfg)
    if router == "zero":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(2, 64, cfg.d_model)
    idx, gates, aux = moe.route(cfg, p, torch.from_numpy(x))
    jidx, jgates, jaux = jmoe.route(jcfg, jp, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, jgates)
    _close(aux, jaux)
    if router == "zero":
        assert (idx.numpy() == np.arange(cfg.moe.top_k)).all()
        assert float(aux) == pytest.approx(1.0, abs=0.25)


def test_ranks_match_bruteforce():
    flat = torch.from_numpy(np.random.default_rng(1).integers(0, 5, (3, 40)))
    want = np.zeros((3, 40), np.int64)
    for r in range(3):
        for j in range(40):
            want[r, j] = int((flat[r, :j] == flat[r, j]).sum())
    np.testing.assert_array_equal(moe.ranks(flat).numpy(), want)


def _reference_plan(idx, gates, cap, e):
    """The dispatch plan as src/repro/models/moe.py:70-103 builds it (its
    ranks and its two scatters, run by XLA): the reference's semantics,
    slot (0, 0) included."""
    b, s, k = idx.shape
    flat_e = jnp.asarray(idx.reshape(b, s * k), jnp.int32)
    ar = jnp.arange(s * k, dtype=jnp.int32)

    def ranks_one(fe):
        order = jnp.argsort(fe, stable=True)
        sorted_e = fe[order]
        is_start = jnp.concatenate([jnp.ones((1,), bool), sorted_e[1:] != sorted_e[:-1]])
        seg_start = jax.lax.cummax(jnp.where(is_start, ar, 0))
        return jnp.zeros_like(fe).at[order].set(ar - seg_start)

    pos = jax.vmap(ranks_one)(flat_e)
    keep = pos < cap
    token_of_slot = jnp.broadcast_to(jnp.repeat(jnp.arange(s), k)[None], (b, s * k))
    bidx = jnp.arange(b)[:, None]
    e_clip, c_clip = jnp.where(keep, flat_e, 0), jnp.where(keep, pos, 0)
    dispatch_idx = jnp.zeros((b, e, cap), jnp.int32).at[bidx, e_clip, c_clip].set(
        jnp.where(keep, token_of_slot, 0), mode="drop")
    slot_w = jnp.zeros((b, e, cap), jnp.float32).at[bidx, e_clip, c_clip].set(
        jnp.where(keep, jnp.asarray(gates.reshape(b, s * k)), 0), mode="drop")
    return np.asarray(dispatch_idx), np.asarray(slot_w), np.asarray(keep)


@pytest.mark.parametrize("case", ["drop-after-expert-0", "drops-before-expert-0",
                                  "no-expert-0", "no-drop", "seeded"])
def test_dispatch_plan_matches_reference_scatter(case):
    """The reference empties slot (0, 0) exactly when a dropped assignment
    follows the row's first assignment to expert 0; the port reproduces it
    without relying on the order of duplicate scatter indices."""
    e, cap = 4, 1
    rows = {"drop-after-expert-0": [[0, 1], [1, 2]],    # expert 1 drops last
            "drops-before-expert-0": [[1, 2], [1, 0]],  # expert 1 drops first
            "no-expert-0": [[1, 2], [1, 3]],
            "no-drop": [[0, 1], [2, 3]]}
    rng = np.random.default_rng(2)
    if case == "seeded":
        e, cap = 4, 3
        idx = np.stack([np.stack([rng.permutation(e)[:2] for _ in range(12)])
                        for _ in range(3)])
    else:
        idx = np.asarray([rows[case]])
    gates = rng.uniform(0.1, 1.0, idx.shape).astype(np.float32)
    d_idx, w, keep, emptied, slot = moe.dispatch_plan(
        torch.from_numpy(idx), torch.from_numpy(gates), cap, e, torch.float32)
    want_idx, want_w, want_keep = _reference_plan(idx, gates, cap, e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(d_idx.numpy(), want_idx)
    np.testing.assert_array_equal(w.numpy(), want_w)
    # every kept assignment's slot holds its token (but an emptied (0, 0))
    tokens = np.broadcast_to(np.repeat(np.arange(idx.shape[1]), idx.shape[2]),
                             keep.shape)
    held = np.take_along_axis(d_idx.reshape(len(idx), -1).numpy(), slot.numpy(), 1)
    owner = keep.numpy() & (w.reshape(len(idx), -1).numpy()[
        np.arange(len(idx))[:, None], slot.numpy()] != 0)
    np.testing.assert_array_equal(held[owner], tokens[owner])
    first0 = {"drop-after-expert-0": True, "drops-before-expert-0": False,
              "no-expert-0": False, "no-drop": False}
    if case in first0:
        assert bool(emptied[0]) == first0[case]


@pytest.mark.parametrize("cf", [8.0, None, 0.25])
def test_apply_moe_matches_reference(cf):
    """No drops (8.0), the reduced default (2.0) and heavy drops (0.25):
    output, aux loss and the set of kept assignments equal the
    reference's; at 0.25 slot (0, 0) is emptied as the reference empties
    it."""
    cfg, jcfg = _cfgs("qwen3_moe_235b_a22b", cf)
    jp, p = _moe_params(jcfg)
    x = _x(2, 16, cfg.d_model)
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)

    s, k, e = 16, cfg.moe.top_k, cfg.moe.n_experts
    cap = max(1, int(s * k * cfg.moe.capacity_factor / e))
    idx, gates, _ = moe.route(cfg, p, torch.from_numpy(x))
    _, _, keep, emptied, _ = moe.dispatch_plan(idx, gates, cap, e, torch.float32)
    jidx, _, _ = jmoe.route(jcfg, jp, jnp.asarray(x))
    np.testing.assert_array_equal(keep.numpy(), _bruteforce_keep(np.asarray(jidx), cap))
    if cf == 8.0:
        assert keep.all() and not emptied.any()
    if cf == 0.25:
        assert (~keep).sum() >= 16 and emptied.all()


def test_shared_expert_matches_reference():
    """llama4's always-on shared expert (a dense MLP of width d_expert)."""
    cfg, jcfg = _cfgs("llama4_maverick_400b_a17b")
    assert cfg.moe.shared_expert
    jp, p = _moe_params(jcfg)
    assert tuple(p["shared"]["w1"].shape) == (cfg.d_model, cfg.moe.d_expert)
    x = _x(2, 12, cfg.d_model)
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    cfg, jcfg = _cfgs("jamba_v01_52b")
    jp = jssm.init_mamba(jcfg, jax.random.key(0))
    return cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("s", [1, 7, 64, 77, 256, 300, 513])
@pytest.mark.parametrize("chunk", [0, 16])
def test_mamba_forward_matches_reference(mamba, s, chunk):
    """Odd and even S, the default chunk (256) and a small one; the port
    keeps its chunk and scans a ragged last one, the reference halves the
    chunk until it divides S. Output and the returned ``{conv, h}``."""
    cfg, jcfg, jp, p = mamba
    x = _x(1, s, cfg.d_model, 0.5)
    y, st = ssm.mamba_forward(cfg, p, torch.from_numpy(x), chunk=chunk,
                              return_state=True)
    jy, jst = jssm.mamba_forward(jcfg, jp, jnp.asarray(x), chunk=chunk,
                                 return_state=True)
    _close(y, jy)
    assert tuple(st["conv"].shape) == jst["conv"].shape
    _close(st["conv"], jst["conv"])
    _close(st["h"], jst["h"])


def test_mamba_decode_matches_reference(mamba):
    """Decode steps from a prefilled state, cache and output each step."""
    cfg, jcfg, jp, p = mamba
    x = _x(2, 21, cfg.d_model, 0.5)
    _, cache = ssm.mamba_forward(cfg, p, torch.from_numpy(x[:, :13]), return_state=True)
    _, jcache = jssm.mamba_forward(jcfg, jp, jnp.asarray(x[:, :13]), return_state=True)
    for t in range(13, 21):
        y, cache = ssm.mamba_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]), cache)
        jy, jcache = jssm.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(y, jy)
        _close(cache["conv"], jcache["conv"])
        _close(cache["h"], jcache["h"])


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8), (5, 16)])
def test_mamba_chunked_matches_stepwise(mamba, s, chunk):
    """The port's chunked scan (whole and ragged last chunks) against its own
    decode stepped token by token from a zero state."""
    cfg, _, _, p = mamba
    x = torch.from_numpy(_x(2, s, cfg.d_model, 0.5))
    y, st = ssm.mamba_forward(cfg, p, x, chunk=chunk, return_state=True)
    cache = ssm.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(s):
        yt, cache = ssm.mamba_decode(cfg, p, x[:, t:t + 1], cache)
        ys.append(yt)
    _close(y, torch.cat(ys, dim=1).numpy(), atol=2e-4, rtol=2e-3)
    _close(st["h"], cache["h"].numpy(), atol=2e-4, rtol=2e-3)
    _close(st["conv"], cache["conv"].numpy())


def test_mamba_init_matches_reference_tree(mamba):
    cfg, _, jp, _ = mamba
    mine = ssm.init_mamba(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in jp.items()}
    _close(mine["A_log"], jp["A_log"])
    _close(mine["dt_bias"], jp["dt_bias"])


def test_slot_00_defect_of_the_reference_is_reproduced():
    """Reduced qwen3-moe, 16 tokens at capacity factor 0.5 (16 of 32
    assignments dropped): against a per-token loop over the kept
    assignments, the reference's output is wrong at exactly the first token
    routed to expert 0, which loses expert 0's contribution (ROADMAP Queue
    C); the port gives the reference's output, defect included."""
    cfg, jcfg = _cfgs("qwen3_moe_235b_a22b", 0.5)
    jp, p = _moe_params(jcfg)
    x = _x(1, 16, cfg.d_model)
    jy, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    y, _ = moe.apply_moe(cfg, p, torch.from_numpy(x))
    _close(y, jy)

    idx, gates, _ = jmoe.route(jcfg, jp, jnp.asarray(x))
    idx, gates = np.asarray(idx)[0], np.asarray(gates)[0]
    w = {k: np.asarray(v) for k, v in jp.items()}
    cap = max(1, int(16 * cfg.moe.top_k * 0.5 / cfg.moe.n_experts))
    loop, seen = np.zeros((16, cfg.d_model), np.float32), {}
    for t in range(16):
        for j, e in enumerate(idx[t]):
            seen[e] = seen.get(e, 0) + 1
            if seen[e] <= cap:
                h, g = x[0, t] @ w["w1"][e], x[0, t] @ w["w3"][e]
                loop[t] += gates[t, j] * ((h / (1 + np.exp(-h)) * g) @ w["w2"][e])
    assert sum(seen.values()) - sum(min(n, cap) for n in seen.values()) == 16
    wrong = np.abs(np.asarray(jy)[0] - loop).max(-1) > 1e-3
    assert list(np.flatnonzero(wrong)) == [int(np.argmax((idx == 0).any(-1)))]


# --------------------------------------------------------------------------
# the combine: a gather and an f32 sum in a fixed order
# --------------------------------------------------------------------------


def _loop_combine(cfg, p, x, idx, gates, cap):
    """The MoE output of x [B, S, D] as a per-token loop over the kept
    assignments in f64, with the reference's slot-(0, 0) overwrite: the
    first assignment of a row to expert 0 is lost when a drop follows it."""
    w = {n: p[n].double().numpy() for n in ("w1", "w2", "w3")}
    b, s, k = idx.shape
    y = np.zeros((b, s, cfg.d_model))
    for r in range(b):
        flat = idx[r].reshape(-1)
        keep = _bruteforce_keep(idx[r:r + 1], cap)[0]
        first0 = next((j for j, e in enumerate(flat) if e == 0), None)
        if first0 is not None and (~keep[first0 + 1:]).any():
            keep[first0] = False
        for j in np.flatnonzero(keep):
            t, e = j // k, flat[j]
            xt = x[r, t].astype(np.float64)
            h, g = xt @ w["w1"][e], xt @ w["w3"][e]
            y[r, t] += gates[r, t, j % k] * ((h / (1 + np.exp(-h)) * g) @ w["w2"][e])
    return y


@pytest.mark.parametrize("cf,seed", [(8.0, 0), (2.0, 1), (0.5, 0), (0.5, 2), (0.25, 3)])
def test_combine_equals_a_loop_over_kept_assignments(cf, seed):
    """f32 apply_moe against the per-token loop: no drops, the reduced
    default and heavy drops, where slot (0, 0) is emptied and the token
    that owned it gets nothing from expert 0, as in the reference."""
    cfg, jcfg = _cfgs("qwen3_moe_235b_a22b", cf)
    _, p = _moe_params(jcfg, seed)
    x = _x(2, 16, cfg.d_model, seed=seed)
    y, _ = moe.apply_moe(cfg, p, torch.from_numpy(x))
    idx, gates, _ = moe.route(cfg, p, torch.from_numpy(x))
    cap = max(1, int(16 * cfg.moe.top_k * cf / cfg.moe.n_experts))
    want = _loop_combine(cfg, p, x, idx.numpy(), gates.double().numpy(), cap)
    _close(y, want)
    if cf <= 0.5:
        _, _, keep, emptied, _ = moe.dispatch_plan(idx, gates, cap,
                                                   cfg.moe.n_experts, torch.float32)
        assert (~keep).any() and emptied.any()


@pytest.mark.parametrize("cf", [8.0, 0.5, 0.25])
def test_combine_matches_reference_with_routing_pinned(cf, monkeypatch):
    """The reference's routing (idx and gates) fed to both layers: the
    outputs agree within the f32 parity tolerance, drops and the emptied
    slot (0, 0) included."""
    cfg, jcfg = _cfgs("qwen3_moe_235b_a22b", cf)
    jp, p = _moe_params(jcfg, 4)
    x = _x(2, 16, cfg.d_model, seed=4)
    jidx, jgates, jaux = jmoe.route(jcfg, jp, jnp.asarray(x))
    idx = torch.from_numpy(np.asarray(jidx).astype(np.int64))
    gates = torch.from_numpy(np.array(jgates))
    monkeypatch.setattr(jmoe, "route", lambda *a: (jidx, jgates, jaux))
    monkeypatch.setattr(moe, "route", lambda *a: (idx, gates, torch.tensor(0.0)))
    y, _ = moe.apply_moe(cfg, p, torch.from_numpy(x))
    jy, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    _close(y, jy)


@pytest.mark.parametrize("arch,experts,seed", [("qwen3_moe_235b_a22b", (16, 8), 0),
                                               ("qwen3_moe_235b_a22b", (16, 8), 5),
                                               ("jamba_v01_52b", (16, 2), 0)])
def test_bf16_combine_rounds_once(arch, experts, seed):
    """In bf16 the routed output equals, bit for bit, each token's kept
    slot outputs summed in f32 in top-k order and cast to bf16 once. An
    add that rounds to bf16 after every contribution (the index_add_ this
    combine replaced) misses it once a token has more than two: the
    published top-k of each arch (8 of 128 for qwen3-moe, 2 of 16 for
    jamba) over 16 experts at the reduced width."""
    cfg, jcfg = _cfgs(arch, 0.5)
    n, top = experts
    cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_experts=n, top_k=top))
                 for c in (cfg, jcfg))
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    _, p = _moe_params(jcfg, seed)
    p = {n: v.to(torch.bfloat16) for n, v in p.items()}
    x = torch.from_numpy(_x(2, 24, cfg.d_model, seed=seed)).to(torch.bfloat16)
    y, _ = moe.apply_moe(cfg, p, x)

    b, s, k, e = 2, 24, cfg.moe.top_k, cfg.moe.n_experts
    cap = max(1, int(s * k * 0.5 / e))
    idx, gates, _ = moe.route(cfg, p, x)
    d_idx, slot_w, keep, _, _ = moe.dispatch_plan(idx, gates, cap, e, torch.bfloat16)
    out = moe.expert_outputs(cfg, p, x, d_idx, slot_w)
    want = torch.zeros((b, s, cfg.d_model))
    kept = _bruteforce_keep(idx.numpy(), cap)
    for r in range(b):
        seen = {}
        for j, ex in enumerate(idx[r].reshape(-1).tolist()):
            pos = seen.get(ex, 0)
            seen[ex] = pos + 1
            if kept[r, j]:
                want[r, j // k] += out[r, ex, pos].float()
    assert not keep.all()
    assert y.dtype == torch.bfloat16 and torch.equal(y, want.to(torch.bfloat16))


def test_bf16_combine_sums_in_top_k_order():
    """Bit for bit on contributions whose f32 sum depends on the order: 16
    tokens, each routed to experts (1, 2, 0) in that top-k order (experts 1
    and 2 tie, so the lower index leads), contributing +B, -B and a small
    s. Summed in top-k order and rounded once the output is s. The
    index_add_ this combine replaced accumulates the slots in expert order
    (on the CPU in f32, on the card as bf16 atomics in no fixed order):
    (s + B) - B, which loses s."""
    cfg, _ = _cfgs("qwen3_moe_235b_a22b", 8.0)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
                              moe=dataclasses.replace(cfg.moe, top_k=3))
    d, f, e = cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts
    bf = dict(dtype=torch.bfloat16)
    p = {"router": torch.zeros((d, e), **bf), "w1": torch.zeros((e, d, f), **bf),
         "w3": torch.zeros((e, d, f), **bf), "w2": torch.zeros((e, f, d), **bf)}
    p["router"][0] = torch.tensor([0.0, 1.0, 1.0, -10.0])
    p["w1"][:, 0, 0], p["w3"][:, 0, 0] = 8.0, 1.0
    p["w2"][:, 0, :] = torch.tensor([0.125, 2.0**24, -2.0**24, 0.0])[:, None]
    x = torch.zeros((1, 16, d), **bf)
    x[..., 0] = 1.0
    y, _ = moe.apply_moe(cfg, p, x)

    idx, gates, _ = moe.route(cfg, p, x)
    assert idx[0, 0].tolist() == [1, 2, 0]
    d_idx, slot_w, keep, _, _ = moe.dispatch_plan(idx, gates, 16, e, torch.bfloat16)
    out = moe.expert_outputs(cfg, p, x, d_idx, slot_w)
    v1, v2, s = out[0, 1, 0, 0].float(), out[0, 2, 0, 0].float(), out[0, 0, 0, 0].float()
    assert v1 == -v2 and v1 + s == v1 and 0 < s
    assert keep.all() and torch.equal(y[..., 0], torch.full((1, 16), float(s), **bf))

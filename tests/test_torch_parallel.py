"""The port's multi-device slice held against the reference on the CPU: the
sharding rules (``parallel/sharding.py``), the activation context, meshes,
specs, the GPipe pipeline, elastic restore, ``psum_int8`` and train steps
on gloo meshes.

Specs: for all ten archs, reduced and full, on the stand-in meshes
``{data 1, model 1}``, ``(2, 4)``, ``(16, 16)`` and ``(pod 2, data 16, model
16)``, every parameter, optimizer (f32, bf16 and int8 moments), cache
(``init_cache(4, 64)``) and batch leaf's spec equals the reference's, the
port's from meta tensors, the reference's from ``jax.eval_shape`` on an
``AbstractMesh``.

The multi-process cases run in gloo process groups of spawned CPU processes
(``tests/torch_dist_cases.py``), every group of cases in one subprocess, all
started at once by the ``runs`` fixture beside the reference's side (one
subprocess on 8 forced host devices). Tolerances: the pipeline's output
within 1e-5 and its gradients within 1e-3 of the reference's and of the
sequential composition (the reference's own bounds); ``psum_int8`` within
1e-5 relative of the reference's (the same quantisation, summed in another
order; bf16 within one bf16 ulp); the train steps as
``torch_dist_cases.close_steps`` states; the elastic moves and the 1x1 mesh
step bit for bit. This file holds reduced yi-6b and qwen3-moe (its MoE pins
on and off); test_torch_parallel_hybrid.py holds jamba and xlstm.
"""
import functools
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import store as jstore
from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsh
from repro_torch import tree
from repro_torch.checkpoint import store
from repro_torch.configs import base as cbase
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import attention
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as sh

import torch_dist_cases as cases

ARCHS = ("yi_6b", "qwen3_moe_235b_a22b")
MESH_ARCHS = ARCHS + ("yi_6b" + cases.INT8,)  # the port's side only


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


STAND_INS = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4},
             "16x16": {"data": 16, "model": 16},
             "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# --------------------------------------------------------------------------
# the rules (the port's copies of tests/test_distribution.py::TestShardingRules)
# --------------------------------------------------------------------------


class TestShardingRules:
    def test_divisibility_guard(self):
        m = FakeMesh({"data": 4, "model": 2})
        assert sh._guard(("data", "model"), (8, 6), m) == ("data", "model")
        assert sh._guard(("data", "model"), (6, 6), m) == (None, "model")  # 6 % 4

    def test_head_aware_overrides(self):
        m = FakeMesh({"data": 16, "model": 16})
        ov = sh.head_aware_overrides(get_config("yi_6b"), m)
        assert "wk" in ov and "wq" not in ov  # kv=4 replicated, 32 heads ok
        assert "wq" in sh.head_aware_overrides(get_config("qwen25_14b"), m)  # 40 heads
        assert sh.head_aware_overrides(get_config("stablelm_3b"), m) == {}  # 32/32


def test_placements_pin():
    """One placement per mesh dim: ``Shard(d)`` of the tensor dim naming
    it, a tuple of axes sharding one dim over each of its mesh dims in
    order, ``Replicate()`` elsewhere; specs normalise as jax's do."""
    from torch.distributed.tensor import Replicate, Shard

    m2 = FakeMesh({"data": 2, "model": 2})
    m3 = FakeMesh({"pod": 2, "data": 2, "model": 2})
    assert sh.placements(("data", "model"), m2) == (Shard(0), Shard(1))
    assert sh.placements((None, "data", "model"), m2) == (Shard(1), Shard(2))
    assert sh.placements(("model", "data"), m2) == (Shard(1), Shard(0))
    assert sh.placements((("pod", "data"), None), m3) == (Shard(0), Shard(0), Replicate())
    assert sh.placements((None, "model"), m3) == (Replicate(), Replicate(), Shard(1))
    assert sh.placements(sh.P(), m3) == sh.replicated(m3) == (Replicate(),) * 3
    assert sh.P(("data",), (), ("pod", "data")) == ("data", None, ("pod", "data"))
    assert tuple(jax.sharding.PartitionSpec(("data",), (), ("pod", "data"))) == \
        sh.P(("data",), (), ("pod", "data"))


def test_mesh_helpers_read_stand_ins_and_refuse_without_a_group():
    m = FakeMesh({"pod": 2, "data": 4, "model": 8})
    assert mesh_mod.dp_axes(m) == ("pod", "data")
    assert mesh_mod.axis_size(m, "model") == 8
    assert mesh_mod.axis_size(m, ("pod", "data")) == 8
    assert mesh_mod.dp_axes(FakeMesh({"model": 4})) == ()
    assert mesh_mod.PRODUCTION_SHAPES == {False: ((16, 16), ("data", "model")),
                                          True: ((2, 16, 16), ("pod", "data", "model"))}
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_production_mesh(device="cpu")


def test_all_configs_match_reference():
    from repro.configs.base import all_configs as jall

    mine, ref = cbase.all_configs(), jall()
    assert list(mine) == list(cbase.ARCH_IDS) and sorted(mine) == sorted(ref)
    assert all(mine[a] == get_config(a) and mine[a].n_layers == ref[a].n_layers
               and mine[a].d_model == ref[a].d_model for a in mine)


# --------------------------------------------------------------------------
# spec parity on the stand-in meshes
# --------------------------------------------------------------------------


def _jcfg(arch, reduced):
    cfg = jget_config(arch)
    return cfg.reduced() if reduced else cfg


def _cfg(arch, reduced):
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg


@functools.lru_cache(maxsize=None)
def _jabstract(arch, reduced):
    model = JModel(_jcfg(arch, reduced))
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    opts = {dt: jax.eval_shape(lambda dt=dt: jadamw.init_state(
        jadamw.AdamWConfig(state_dtype=dt), params)) for dt in ("float32", "bfloat16", "int8")}
    return params, opts, jspecs.abstract_cache(model, 4, 64)


def _jspec(sharding_tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        sharding_tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, reduced):
    """Every parameter, optimizer, cache and batch leaf, on each stand-in
    mesh; the port's abstract trees from meta tensors have the reference's
    shapes and dtypes."""
    cfg, jcfg = _cfg(arch, reduced), _jcfg(arch, reduced)
    model = Model(cfg, device="cpu")
    params = specs.abstract_params(model)
    jparams, jopts, jcache = _jabstract(arch, reduced)
    assert [tuple(t.shape) for t in tree.leaves(params)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jparams)]
    assert all(t.device.type == "meta" for t in tree.leaves(params))
    assert [str(t.dtype).removeprefix("torch.") for t in tree.leaves(params)] == \
        [str(a.dtype) for a in jax.tree.leaves(jparams)]
    cache = specs.abstract_cache(model, 4, 64)
    assert [tuple(t.shape) for t in tree.leaves(cache)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jcache)]
    batch = specs.batch_specs(cfg, 8, 64)
    jbatch = jspecs.batch_specs(jcfg, 8, 64)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jbatch.items()}
    paths = tree.key_paths(params)
    for name, shape in STAND_INS.items():
        fake, amesh = FakeMesh(shape), AbstractMesh(tuple(shape.values()), tuple(shape))
        for use_cfg in (None, cfg):
            ov = sh.head_aware_overrides(use_cfg, fake)
            jov = jsh.head_aware_overrides(jcfg if use_cfg else None, amesh)
            assert ov == jov, name
            got = [sh.param_spec(p, t, fake, overrides=ov)
                   for p, t in zip(paths, tree.leaves(params))]
            want = [tuple(jsh.param_spec(p, a, amesh, overrides=jov)) for p, a in
                    jax.tree_util.tree_flatten_with_path(jparams)[0]]
            assert got == want, (name, use_cfg is not None)
        for dt, jopt in jopts.items():
            opt = adamw.init_state(adamw.AdamWConfig(state_dtype=dt), params)
            got = sh.opt_state_specs(opt, params, fake, cfg)
            # jax's leaf order of {step, m, v}: m, step, v
            got = _spec_leaves(params, got["m"]) + [got["step"]] + _spec_leaves(params, got["v"])
            want = _jspec(jsh.opt_state_sharding(jopt, jparams, amesh, jcfg))
            assert got == want, (name, dt)
            placed = sh.opt_state_sharding(opt, params, fake, cfg)
            assert placed["step"] == sh.replicated(fake)
        got = [sh.cache_spec(p, t, fake) for p, t in
               zip(tree.key_paths(cache), tree.leaves(cache))]
        assert got == _jspec(jsh.cache_sharding(jcache, amesh)), name
        got = [sh.batch_spec(batch[k], fake) for k in sorted(batch)]
        assert got == _jspec(jsh.batch_sharding(jbatch, amesh)), name
        pl = tree.leaves(sh.params_sharding(params, fake, cfg))
        assert len(pl) == len(tree.leaves(params)) * len(shape)


def _spec_leaves(params, specs_tree):
    """The moment specs in leaf order, an int8 leaf's ``{q, scale}`` as q
    then scale (jax's order for the dict)."""
    out = []
    for s in tree.flatten_up_to(params, specs_tree):
        out.extend([s["q"], s["scale"]] if isinstance(s, dict) else [s])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_recommended_state_dtype_matches_reference(arch):
    """At the reference's 16 GiB x 256 the reference's choice; the defaults
    are the H100's 80 GiB and the production mesh's 256 devices."""
    from repro_torch.hw.gpu_h100 import HBM_BYTES

    cfg = get_config(arch)
    assert specs.recommended_state_dtype(cfg, hbm_bytes=16 * 1024**3, n_devices=256) == \
        jspecs.recommended_state_dtype(jget_config(arch))
    assert HBM_BYTES == 80 * 1024**3
    assert specs.recommended_state_dtype(cfg) == specs.recommended_state_dtype(
        cfg, hbm_bytes=HBM_BYTES, n_devices=256)


def test_shape_cells_and_decode_specs_match_reference():
    assert specs.SHAPES == jspecs.SHAPES
    for arch in ARCH_IDS:
        for shape in specs.SHAPES:
            assert specs.shape_applicable(get_config(arch), shape) == \
                jspecs.shape_applicable(jget_config(arch), shape)
    cfg = get_config("whisper_large_v3")
    got = specs.infer_batch_specs(cfg, 2, 32)
    want = jspecs.infer_batch_specs(jget_config("whisper_large_v3"), 2, 32)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    got = specs.decode_specs(cfg, 4, 64)
    assert {k: tuple(v.shape) for k, v in got.items()} == {"tokens": (4,), "pos": ()}


# --------------------------------------------------------------------------
# the context and the attention's local heads (no process group)
# --------------------------------------------------------------------------


def test_constraints_are_no_ops_without_a_mesh():
    x = torch.randn(2, 4, 8)
    assert pctx.constrain_tokens(x) is x and pctx.batch_only(x) is x
    pctx.install(("data",), tp_size=2, sp_seq=True, moe_pin=True)
    try:
        assert pctx.constrain_tokens(x) is x  # a plain tensor
        assert pctx.constrain_dims(x, ("dp", "tp")) is x
        assert pctx.moe_pin() and pctx.dp_axes() == ("data",) and pctx.mesh() is None
        with pctx.activation_sharding(("pod", "data")):
            assert pctx.dp_axes() == ("pod", "data")
        assert pctx.dp_axes() == ("data",)
    finally:
        pctx.clear()
    assert pctx.dp_axes() is None and not pctx.moe_pin()
    f = lambda a, b: (a + b, a * b)
    y = pctx.map_rows(f, (x, x), (True, False), n_out=2)  # a plain call
    assert torch.equal(y[0], x + x) and torch.equal(y[1], x * x)


@pytest.mark.parametrize("hq, hkv, tp", [(4, 2, 4), (8, 2, 4), (32, 4, 16), (6, 2, 3),
                                         (12, 4, 6), (40, 8, 8)])
def test_local_kv_heads_are_each_query_heads_own(hq, hkv, tp):
    """A rank's query heads ``[r hq/tp, (r+1) hq/tp)`` attend with their own
    key heads (query head i reads key head i // (hq/hkv)) when the key heads
    are whole on every rank: the GQA attention of the local heads equals
    those heads' rows of the whole attention."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    g = torch.Generator().manual_seed(hq * 100 + tp)
    q, k, v = (torch.randn(1, h, 8, 16, generator=g) for h in (hq, hkv, hkv))
    whole = flash_attention_plain(q, k, v, causal=True)
    n = hq // tp
    for r in range(tp):
        kl, vl = attention._local_kv(k, v, r * n, n, hq // hkv)
        got = flash_attention_plain(q[:, r * n:(r + 1) * n].contiguous(), kl, vl, causal=True)
        torch.testing.assert_close(got, whole[:, r * n:(r + 1) * n], rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the multi-process cases
# --------------------------------------------------------------------------


def _pipe_inputs():
    rng = np.random.default_rng(0)
    n_stages, n_micro, mb, d = 4, 6, 3, 16
    w = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return {"params": {"w": w, "b": b}, "x": x}


def _psum_inputs():
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((4, 8, 256)).astype(np.float32)
    return {"f32": f32, "odd": rng.standard_normal((4, 8, 100)).astype(np.float32),
            "bf16": f32}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = cases.write_train_inputs(tmp / "inputs.pt", MESH_ARCHS)
    pipe, psum = _pipe_inputs(), _psum_inputs()
    torch.save({"params": {k: torch.from_numpy(v) for k, v in pipe["params"].items()},
                "x": torch.from_numpy(pipe["x"])}, tmp / "pipe.pt")
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16 if k == "bf16" else torch.float32)
                for k, v in psum.items()}, tmp / "psum.pt")
    jp = JModel(jget_config("yi_6b").reduced()).init(jax.random.key(0))
    jstore.save(str(tmp / "ck_ref"), 3, jp)
    store.save(str(tmp / "ck_port"), 5, inputs["yi_6b"]["params"])
    with open(tmp / "ref_job.pkl", "wb") as f:
        pickle.dump({"pipe": pipe, "psum": {k: (v.astype(jnp.bfloat16) if k == "bf16" else v)
                                            for k, v in psum.items()},
                     "archs": ARCHS, "lr": cases.LR,
                     "meshes": [("train", (2, 2), False), ("train24", (2, 4), True)],
                     "batches": {a: inputs[a]["batches"] for a in ARCHS}}, f)
    jobs = {
        "reference": cases.start_reference(tmp / "ref_job.pkl", tmp / "ref_out.pkl"),
        "2x2": cases.start("train", 4, tmp, tmp / "inputs.pt", name="t22", mesh=[2, 2],
                           archs=MESH_ARCHS, moe_pin=[False, True]),
        "1x4": cases.start("train", 4, tmp, tmp / "inputs.pt", name="t14", mesh=[1, 4],
                           archs=MESH_ARCHS, head_aware=True),
        "2x4": cases.start("train", 8, tmp, tmp / "inputs.pt", name="t24", mesh=[2, 4],
                           archs=ARCHS, head_aware=True),
        "serve": cases.start("serve", 8, tmp, tmp / "inputs.pt", mesh=[2, 4], archs=ARCHS),
        "loss": cases.start("loss", 8, tmp, tmp / "inputs.pt", mesh=[2, 4], arch="yi_6b"),
        "one_rank": cases.start("one_rank", 1, tmp, tmp / "inputs.pt", archs=MESH_ARCHS),
        "pipeline": cases.start("pipeline", 8, tmp, tmp / "pipe.pt", mesh=[4, 2]),
        "elastic": cases.start("elastic", 4, tmp, arch="yi_6b",
                               dirs={"port": str(tmp / "ck_port"), "ref": str(tmp / "ck_ref")}),
        "psum": cases.start("psum", 4, tmp, tmp / "psum.pt"),
    }
    yield jobs
    for job in jobs.values():
        job.kill()


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_one_by_one_mesh_step_is_bit_equal_to_meshless(runs, arch):
    """On a one-rank gloo group, a 1x1 mesh: both steps' metrics and every
    parameter and moment leaf equal the meshless run's bit for bit, and the
    leaves keep the rules' placements; and ``train()`` with
    ``mesh_shape=(1, 1)`` (two steps, two microbatches, int8 compression)
    ends bit-equal to ``train()`` without."""
    (mm, ml, placed, _), (pm, pl, _, _) = runs["one_rank"].result()[arch]
    assert placed and mm == pm
    assert len(ml) == len(pl) and all(torch.equal(a, b) for a, b in zip(ml, pl))
    if arch in ARCHS:
        (ml, mleaves), (pl, pleaves) = runs["one_rank"].result()[("trainer", arch)]
        assert ml == pl and len(mleaves) == len(pleaves)
        assert all(torch.equal(a, b) for a, b in zip(mleaves, pleaves))


TRAIN_CASES = [("2x2", "yi_6b", False), ("2x2", "qwen3_moe_235b_a22b", False),
               ("2x2", "qwen3_moe_235b_a22b", True), ("2x2", "yi_6b@int8", False),
               ("1x4", "yi_6b", False), ("1x4", "qwen3_moe_235b_a22b", False),
               ("1x4", "yi_6b@int8", False),
               ("2x4", "yi_6b", False), ("2x4", "qwen3_moe_235b_a22b", False)]
REFERENCE_KEYS = {"2x2": "train", "2x4": "train24"}


@pytest.mark.parametrize("mesh, arch, pin", TRAIN_CASES)
def test_mesh_train_steps_match_meshless_and_reference(runs, mesh, arch, pin):
    """Two steps (the second with accum_steps=2, int8 compression and
    grad_shardings) on a gloo mesh: within ``close_steps`` of the port's
    meshless run and, on 2x2 and 2x4, of the reference's meshed run. The
    1x4 and 2x4 meshes use the head-aware rules: reduced yi-6b's and
    qwen3-moe's 2 key heads stay whole and each rank's one query head
    takes its own (the 2x2 mesh shards both). 2x4 is the reference's mini
    dry-run mesh: with a data axis over 1 and key heads that do not divide
    ``model``, DTensor sharded the key projection's output over ``model``
    and its split into heads failed (``attention._whole_heads`` repairs it).
    ``yi_6b@int8`` (int8 moments, d_ff 512) updates its int8 leaves, whose
    last axis is sharded over ``model``, on whole rows; it has no reference
    run here (tests/test_torch_substrate.py holds the int8 state against
    the reference)."""
    got = runs[mesh].result()[(arch, pin)]
    assert got[2], "a leaf lost its rule placements"
    meshless = runs["one_rank"].result()[arch][1]
    cases.close_steps(got, meshless, arch, f"{mesh} vs meshless")
    if mesh in REFERENCE_KEYS and arch in ARCHS:
        cases.close_steps(got, runs["reference"].result()[REFERENCE_KEYS[mesh]][arch], arch,
                          f"{mesh} vs reference")


# meshed serving against meshless, f32: the same sums in another order and
# grouping, and on 2x4 a softmax over positions split across ``model`` put
# together from all-reduced maxima and sums
SERVE_TOL = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_meshless(runs, arch):
    """Prefill of 8 x 12 tokens into a cache of 16 positions and two decode
    steps on a 2x4 gloo mesh with the head-aware rules, the cache placed by
    ``cache_sharding`` (2 key heads over 4 ranks: the positions split over
    ``model``, so each rank writes and attends over its own 4): the last
    logits of the prefill and of each decode step, and every cache leaf
    whole, within ``SERVE_TOL`` (relative and absolute) of the meshless
    run's."""
    (mlog, mcache), (plog, pcache) = runs["serve"].result()[arch]
    assert len(mlog) == len(plog) == 3 and len(mcache) == len(pcache)
    for i, (a, b) in enumerate(zip(mlog, plog)):
        torch.testing.assert_close(a, b, rtol=SERVE_TOL, atol=SERVE_TOL, msg=f"logits {i}")
    for i, (a, b) in enumerate(zip(mcache, pcache)):
        torch.testing.assert_close(a, b, rtol=SERVE_TOL, atol=SERVE_TOL, msg=f"cache leaf {i}")


# the meshed loss and gradients against meshless, f32: the same sums in
# another order and grouping, the vocab's logsumexp put together from the
# ranks' own
LOSS_TOL = 1e-5


@pytest.mark.parametrize("layout", ["picked", pctx.TOKEN_GATHERED, pctx.WEIGHT_GATHERED])
@pytest.mark.parametrize("sp", [False, True], ids=["whole", "sp_seq"])
def test_vocab_parallel_loss_and_grads_match_meshless(runs, sp, layout):
    """Reduced yi-6b's loss on 4 x 16 tokens and its gradient for every
    parameter leaf on a 2x4 gloo mesh (the head-aware rules), within
    ``LOSS_TOL`` of the meshless port's: the cross-entropy vocab-parallel
    (each rank's 64 of the 256 logits), the activations between blocks
    whole or sharded over the sequence (``sp_seq``), each block part's
    products in the layout ``pctx.pick_layout`` picks or forced into each
    layout (``pctx.region``)."""
    got = runs["loss"].result()
    (want_loss, want), (loss, grads) = got["meshless"], got[(sp, layout)]
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        torch.testing.assert_close(a, b, rtol=LOSS_TOL, atol=LOSS_TOL, msg=f"gradient {i}")


def test_pipeline_matches_reference_and_sequential(runs):
    """4 stages, 6 microbatches of 3 x 16 over ('pod', 'model') = (4, 2):
    forward within 1e-5, gradients within 1e-3 (the reference's bounds),
    the output the same on all 8 ranks."""
    got = runs["pipeline"].result()
    ref = runs["reference"].result()["pipe"]
    p = _pipe_inputs()
    w = torch.from_numpy(p["params"]["w"]).requires_grad_(True)
    b = torch.from_numpy(p["params"]["b"]).requires_grad_(True)
    h = torch.from_numpy(p["x"])
    for s in range(4):
        h = torch.tanh(h @ w[s] + b[s])
    (h ** 2).sum().backward()
    assert got["replicated"]
    for want_out, want_g in ((ref["out"], ref["grads"]),
                             (h.detach().numpy(), {"w": w.grad.numpy(), "b": b.grad.numpy()})):
        assert np.abs(got["out"].numpy() - want_out).max() < 1e-5
        for k in ("w", "b"):
            assert np.abs(got["grads"][k].numpy() - want_g[k]).max() < 1e-3


@pytest.mark.parametrize("source", ["port", "ref"])
def test_restore_on_mesh_and_reshard_live_are_bit_exact(runs, source):
    """A checkpoint of reduced yi-6b saved by the meshless port or by the
    reference's ``checkpoint.store``, restored onto a 2x2 gloo mesh (the
    rules' placements), then moved live 2x2 -> 4x1 -> 1x1: every leaf whole
    equals the saved one bit for bit (the port's copy of
    tests/test_system.py::TestElastic)."""
    got = runs["elastic"].result()[source]
    assert got["placed"] and got["step"] == {"port": 5, "ref": 3}[source]
    saved = got["whole"]["saved"]
    for key in ("2x2", "4x1", "1x1"):
        assert len(got["whole"][key]) == len(saved)
        assert all(torch.equal(a, b) for a, b in zip(got["whole"][key], saved)), key


@pytest.mark.parametrize("name", ["f32", "odd", "bf16"])
def test_psum_int8_matches_reference(runs, name):
    """Across 4 gloo ranks against the reference's ``psum_int8`` under
    shard_map on 4 host devices: f32 within 1e-5 relative of the largest
    value; a last axis of 100 takes the plain sum; bf16 within one bf16
    ulp."""
    got = runs["psum"].result()[name].float().numpy()
    want = runs["reference"].result()["psum"][name]
    scale = float(np.abs(want).max())
    tol = 2 ** -7 * scale if name == "bf16" else 1e-5 * scale
    assert got.shape == want.shape and np.abs(got - want).max() <= tol


def test_new_modules_import_without_touching_a_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.parallel.sharding, "
            "repro_torch.parallel.context, repro_torch.parallel.pipeline, "
            "repro_torch.launch.specs, repro_torch.checkpoint.elastic\n"
            "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=cases._env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]

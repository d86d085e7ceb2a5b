"""Multi-process cases of the port's multi-device slice, run on the CPU in
gloo process groups for tests/test_torch_parallel.py (no jax here):

    PYTHONPATH=src python tests/torch_dist_cases.py JOB.json

The job names a case, a world size, a ``FileStore`` path and the case's
inputs and output file (``torch.save``). The ranks are spawned (not forked),
join a group on the file store, run the case with one thread each, and
destroy the group; rank 0 writes the output. ``start`` launches a job in a
subprocess from a test, and ``REFERENCE`` is the script that runs the
reference's side of the same cases on forced host devices.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import collectives
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as sh

AXES = ("data", "model")
LR = 1e-3  # the train steps' learning rate, on both sides


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _state_leaves(params, opt_state):
    """Every parameter and moment leaf whole (a collective on a mesh)."""
    return ([_whole(t).detach().clone() for t in tree.leaves(params)]
            + [_whole(t).detach().clone() for t in tree.leaves(opt_state["m"])]
            + [_whole(t).detach().clone() for t in tree.leaves(opt_state["v"])])


INT8 = "@int8"  # a case name's suffix: d_ff 512 and int8 moments


def reduced_config(name, get=get_config):
    """The reduced config of a case name (``get`` is either package's
    ``get_config``): ``yi_6b@int8`` is reduced yi-6b with d_ff 512, so that
    w1 and w3 ([2, 64, 512], 65536 elements) take int8 moments, and w1's
    last axis is sharded over ``model``."""
    import dataclasses

    arch, _, variant = name.partition("@")
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, d_ff=512) if variant else cfg


def run_steps(arch, params, batches, mesh=None, head_aware=False, lr=LR):
    """Two train steps of the reduced ``arch`` in f32 from ``params``
    (whole tensors): the first plain, the second with ``accum_steps=2``,
    int8 gradient compression and (on a mesh) ``grad_shardings``; int8
    moments for an ``@int8`` case, f32 otherwise. Returns ([metrics of each
    step], every parameter and moment leaf whole, whether each leaf kept
    its rule placements)."""
    cfg = reduced_config(arch)
    model = Model(cfg, device="cpu")
    opt = adamw.AdamWConfig(lr=lr, state_dtype="int8" if arch.endswith(INT8) else "float32")
    params = tree.map(lambda t: t.clone(), params)
    opt_state = adamw.init_state(opt, params)
    p_sh = None
    if mesh is not None:
        rules_cfg = cfg if head_aware else None
        p_sh = sh.params_sharding(params, mesh, rules_cfg)
        o_sh = sh.opt_state_sharding(opt_state, params, mesh, rules_cfg)
        params = sh.distribute(params, p_sh, mesh)
        opt_state = sh.distribute(opt_state, o_sh, mesh)
    first = steps.make_train_step(model, opt)
    second = steps.make_train_step(model, opt, accum_steps=2, grad_compression="int8",
                                   grad_shardings=p_sh)
    metrics = []
    for step_fn, batch in zip((first, second), batches):
        params, opt_state, m = step_fn(params, opt_state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    placed = True
    if mesh is not None:
        placed = all(tuple(t.placements) == tuple(p) for t, p in
                     zip(tree.leaves(params), tree.flatten_up_to(params, p_sh)))
    return metrics, _state_leaves(params, opt_state), placed, len(tree.leaves(params))


def case_train(rank, world, job, inputs):
    """The train steps of every arch of the job on its mesh."""
    mesh = mesh_mod.make_mesh(job["mesh"], AXES, device="cpu")
    out = {}
    for arch in job["archs"]:
        for pin in job.get("moe_pin", [False]):
            cfg = reduced_config(arch)
            if pin and cfg.moe is None:
                continue
            pctx.install(("data",), tp_size=mesh_mod.axis_size(mesh, "model"),
                         sp_seq=False, mesh=mesh, moe_pin=pin)
            try:
                out[(arch, pin)] = run_steps(arch, inputs[arch]["params"],
                                             inputs[arch]["batches"], mesh,
                                             head_aware=job.get("head_aware", False))
            finally:
                pctx.clear()
    return out


def _trainer_leaves(arch, mesh_shape):
    """Every leaf of ``train()``'s final state and its loss history: two
    steps of 4 x 16 tokens, two microbatches, int8 compression."""
    from repro_torch.launch.train import TrainOptions, train

    out = train(get_config(arch).reduced(), TrainOptions(
        steps=2, batch=4, seq=16, accum_steps=2, grad_compression="int8", log_every=1,
        mesh_shape=mesh_shape, device="cpu"))
    local = [t.to_local() if hasattr(t, "to_local") else t
             for t in tree.leaves((out["params"], out["opt_state"]))]
    return [loss for _, loss, _ in out["history"]], local


def _serve(arch, params, tokens, mesh=None, prompt=12):
    """Prefill 8 x ``prompt`` tokens into a cache of 16 positions, then a
    decode step for each token after the prompt (all rows at one depth):
    the logits of each, and every cache leaf, whole. On a mesh the
    parameters and the prompt are placed by the head-aware rules, and the
    cache by ``cache_sharding``."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = reduced_config(arch)
    model = Model(cfg, device="cpu")
    params = tree.map(lambda t: t.clone(), params)
    batch = {"tokens": torch.as_tensor(tokens[:, :prompt])}
    replicate = contextlib.nullcontext()
    if mesh is not None:
        params = sh.distribute(params, sh.params_sharding(params, mesh, cfg), mesh)
        batch = sh.distribute(batch, sh.batch_sharding(batch, mesh), mesh)
        replicate = implicit_replication()
    out = []
    with torch.no_grad(), replicate:
        cache, pos, logits = steps.make_prefill_step(model, 16)(params, batch)
        out.append(_whole(logits))
        step = steps.make_serve_step(model)
        for i in range(prompt, tokens.shape[1]):
            tok = {"t": torch.as_tensor(tokens[:, i])}
            if mesh is not None:
                tok = sh.distribute(tok, sh.batch_sharding(tok, mesh), mesh)
            logits, cache = step(params, cache, tok["t"], torch.tensor(i))
            out.append(_whole(logits))
        leaves = [_whole(t).clone() for t in tree.leaves(cache)]
    return out, leaves


def case_serve(rank, world, job, inputs):
    """Prefill and decode of every arch of the job on its mesh (the
    head-aware rules) and meshless, on the same rank: a prompt of the job's
    ``prompt`` tokens (default 12), then one decode step per token up to
    the 14th."""
    mesh = mesh_mod.make_mesh(job["mesh"], AXES, device="cpu")
    prompt = job.get("prompt", 12)
    out = {}
    for arch in job["archs"]:
        p, toks = inputs[arch]["params"], inputs[arch]["tokens"]
        pctx.install(("data",), tp_size=mesh_mod.axis_size(mesh, "model"), sp_seq=False,
                     mesh=mesh)
        try:
            meshed = _serve(arch, p, toks, mesh, prompt)
        finally:
            pctx.clear()
        out[arch] = (meshed, _serve(arch, p, toks, prompt=prompt))
    return out


def _loss_and_grads(arch, params, batch, mesh=None):
    """``Model.loss`` of the reduced ``arch`` in f32 and its gradient for
    every parameter leaf, whole (on a mesh the parameters and the batch
    placed by the head-aware rules)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = reduced_config(arch)
    model = Model(cfg, device="cpu")
    params = tree.map(lambda t: t.clone(), params)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    replicate = contextlib.nullcontext()
    if mesh is not None:
        params = sh.distribute(params, sh.params_sharding(params, mesh, cfg), mesh)
        batch = sh.distribute(batch, sh.batch_sharding(batch, mesh), mesh)
        replicate = implicit_replication()
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with replicate:
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    return _whole(loss).detach(), [_whole(g).detach() for g in grads]


def case_loss(rank, world, job, inputs):
    """The loss (its cross-entropy vocab-parallel) and every gradient of
    the job's arch on its mesh, with the activations between blocks whole
    and with them sharded over the sequence, each block part in the layout
    ``pctx.pick_layout`` picks and in each layout forced; and meshless."""
    mesh = mesh_mod.make_mesh(job["mesh"], AXES, device="cpu")
    arch = job["arch"]
    p, batch = inputs[arch]["params"], inputs[arch]["batches"][0]
    pick = pctx.pick_layout
    out = {"meshless": _loss_and_grads(arch, p, batch)}
    for sp in (False, True):
        for layout in ("picked", pctx.TOKEN_GATHERED, pctx.WEIGHT_GATHERED):
            if layout != "picked":
                pctx.pick_layout = lambda *a, layout=layout, **kw: layout
            pctx.install(("data",), tp_size=mesh_mod.axis_size(mesh, "model"), sp_seq=sp,
                         mesh=mesh)
            try:
                out[(sp, layout)] = _loss_and_grads(arch, p, batch, mesh)
            finally:
                pctx.clear()
                pctx.pick_layout = pick
    return out


def case_one_rank(rank, world, job, inputs):
    """On a one-rank group: the 1x1 mesh's steps and the meshless steps;
    ``train()`` with ``mesh_shape=(1, 1)`` and without."""
    mesh = mesh_mod.make_mesh((1, 1), AXES, device="cpu")
    out = {}
    for arch in job["archs"]:
        p, b = inputs[arch]["params"], inputs[arch]["batches"]
        pctx.install(("data",), tp_size=1, sp_seq=False, mesh=mesh)
        try:
            meshed = run_steps(arch, p, b, mesh)
        finally:
            pctx.clear()
        out[arch] = (meshed, run_steps(arch, p, b))
        if not arch.endswith(INT8):
            out[("trainer", arch)] = (_trainer_leaves(arch, (1, 1)),
                                      _trainer_leaves(arch, None))
    return out


def case_pipeline(rank, world, job, inputs):
    """``pipeline_apply`` over ``("pod", "model")`` = (4, 2): the output
    and the gradients of sum(out ** 2)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = mesh_mod.make_mesh(job["mesh"], ("pod", "model"), device="cpu")
    params = {k: torch.as_tensor(v) for k, v in inputs["params"].items()}
    params = sh.distribute(params, tree.map(lambda _: (Shard(0), Replicate()), params), mesh)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    x = torch.as_tensor(inputs["x"])

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, params, x, mesh=mesh, axis="pod")
    (out ** 2).sum().backward()
    grads = {k: v.grad.full_tensor() for k, v in params.items()}
    same = [torch.equal(out, o) for o in _gathered(out)]
    return {"out": out.detach(), "grads": grads, "replicated": all(same)}


def _gathered(t):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.detach().contiguous())
    return parts


def case_elastic(rank, world, job, inputs):
    """``restore_on_mesh`` of each checkpoint onto a 2x2 mesh, then
    ``reshard_live`` 2x2 -> 4x1 -> 1x1: every leaf whole after each move,
    and whether the placements are the rules'."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import elastic, store

    cfg = get_config(job["arch"]).reduced()
    like = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    m22 = mesh_mod.make_mesh((2, 2), AXES, device="cpu")
    m41 = mesh_mod.make_mesh((4, 1), AXES, device="cpu")
    m11 = DeviceMesh("cpu", [[0]], mesh_dim_names=AXES)
    out = {}
    for name in job["dirs"]:
        saved, manifest = store.restore(job["dirs"][name], like)
        on22, manifest = elastic.restore_on_mesh(job["dirs"][name], like, m22, kind="params")
        rules = tree.flatten_up_to(like, sh.params_sharding(like, m22))
        placed = all(tuple(t.placements) == tuple(p)
                     for t, p in zip(tree.leaves(on22), rules))
        on41 = elastic.reshard_live(on22, sh.params_sharding(like, m41), m41)
        on11 = elastic.reshard_live(on41, sh.params_sharding(like, m11), m11)
        whole = {"saved": [t.clone() for t in tree.leaves(saved)]}
        for key, t in (("2x2", on22), ("4x1", on41)):
            whole[key] = [x.full_tensor() for x in tree.leaves(t)]
        whole["1x1"] = ([x.to_local().clone() for x in tree.leaves(on11)] if rank == 0
                        else None)
        out[name] = {"whole": whole, "placed": placed, "step": manifest["step"]}
    return out


def case_psum(rank, world, job, inputs):
    """``psum_int8`` of each rank's slice of the inputs over the world."""
    out = {}
    for name, x in inputs.items():
        mine = torch.as_tensor(x[rank])
        out[name] = collectives.psum_int8(mine)
    return out


# ---------------------------------------------------------------------------
# comparisons (the tests')
# ---------------------------------------------------------------------------

# Tolerances of a meshed train step against a meshless one or the reference's
# meshed step (f32; the same sums in another order and grouping):
#   metrics (loss, ce, aux, grad_norm): rtol 1e-5;
#   parameters: 1e-5 absolute and relative (they move by at most about lr);
#   moments: one int8 level of the leaf, max|leaf| / 127, absolute: the second
#     step's gradients go through the int8 round trip, and a gradient within
#     rounding of a level boundary may take the neighbouring level.
# xlstm-1.3b's stack is ill-conditioned (tests/test_torch_train.py's
# docstring: one f32 ulp on its parameters moves its gradients by up to 2%):
# its metrics and moments hold to test_torch_xlstm.py's STACK_TOL, 5e-2
# relative (of the leaf's largest value for a moment), its parameters to 1e-4.
STEP_TOL = {"metric": 1e-5, "param": 1e-5, "moment": 1 / 127}
XLSTM_TOL = {"metric": 5e-2, "param": 1e-4, "moment": 5e-2}


def _np(t):
    """A leaf as a numpy array (bf16 as f32)."""
    import numpy as np

    if hasattr(t, "numpy"):
        import torch

        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def close_steps(got, want, arch, what=""):
    """``got`` and ``want`` are (metrics of each step, leaves, ...): every
    parameter leaf (``got[3]`` of them), then every moment leaf of m and v.
    An int8 state (the
    ``@int8`` cases) holds as tests/test_torch_substrate.py's: the
    parameters within lr absolute, each quantised moment within one level
    (a moment within rounding of a level boundary may take the neighbouring
    level, which moves that element's next update by up to about lr)."""
    import numpy as np

    tol = XLSTM_TOL if arch.startswith("xlstm") else STEP_TOL
    if arch.endswith(INT8):
        tol = dict(tol, param=LR)
    (gm, gl), (wm, wl) = got[:2], want[:2]
    for i, (a, b) in enumerate(zip(gm, wm)):
        assert sorted(a) == sorted(b), (what, i)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=tol["metric"],
                                       err_msg=f"{what} step {i + 1} {k}")
    assert len(gl) == len(wl), what
    n = got[3]
    for i, (a, b) in enumerate(zip(gl, wl)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, i)
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, (what, i)
        elif i < n:
            np.testing.assert_allclose(a, b, atol=tol["param"], rtol=tol["param"],
                                       err_msg=f"{what} parameter {i}")
        else:
            bound = tol["moment"] * max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= bound, (what, "moment", i - n)


CASES = {"train": case_train, "one_rank": case_one_rank, "pipeline": case_pipeline,
         "elastic": case_elastic, "psum": case_psum, "serve": case_serve, "loss": case_loss}


def _rank(rank, world, job):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['store']}",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(job["inputs"], weights_only=False) if job.get("inputs") else None
        out = CASES[job["case"]](rank, world, job, inputs)
        if rank == 0:
            torch.save(out, job["out"])
        dist.barrier()
    finally:
        dist.destroy_process_group()


SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 600


class Job:
    """A subprocess running one job; ``result()`` waits for it (with a
    timeout) and returns rank 0's output."""

    def __init__(self, argv, out, env):
        self.out = out
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, env=env)
        self._result = None

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()

    def result(self):
        if self._result is None:
            self._result = self._wait()
        return self._result

    def _wait(self):
        import torch

        try:
            _, err = self.proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            _, err = self.proc.communicate()
            raise AssertionError(f"timed out after {TIMEOUT} s: {err[-3000:]}")
        assert self.proc.returncode == 0, err[-3000:]
        if str(self.out).endswith(".pkl"):
            import pickle

            with open(self.out, "rb") as f:
                return pickle.load(f)
        return torch.load(self.out, weights_only=False)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def start(case, world, tmp, inputs=None, name=None, **job):
    """Launch ``case`` on ``world`` gloo ranks in a subprocess; ``inputs``
    (a path written with ``torch.save``) is loaded by every rank. ``name``
    (default the case's) names its files under ``tmp``."""
    tmp, name = Path(tmp), name or case
    job = dict(job, case=case, world=world, store=str(tmp / f"{name}.store"),
               inputs=str(inputs) if inputs else None, out=str(tmp / f"{name}.out"))
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(job))
    return Job([sys.executable, __file__, str(path)], job["out"], _env())


def write_train_inputs(path, archs):
    """The archs' reduced parameters (the reference's ``jax.random.key(0)``
    draw through ``from_jax``), two batches of 4 x 16 tokens and 8 x 14
    prompt tokens (``case_serve``'s) from numpy seed 0, written to ``path``; returns them (for the tests, which have
    jax)."""
    import jax
    import numpy as np
    import torch

    from repro.configs.base import get_config as jget_config
    from repro.models.model import Model as JModel
    from repro_torch.weights import from_jax

    inputs = {}
    for arch in archs:
        jp = JModel(reduced_config(arch, jget_config)).init(jax.random.key(0))
        rng = np.random.default_rng(0)
        toks = [rng.integers(0, reduced_config(arch).vocab, (4, 17)).astype(np.int32)
                for _ in range(2)]
        inputs[arch] = {"params": from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                        "batches": [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks],
                        "tokens": rng.integers(0, reduced_config(arch).vocab,
                                               (8, 14)).astype(np.int32)}
    torch.save(inputs, path)
    return inputs


def start_reference(job_pkl, out_pkl, devices=8):
    """Run ``REFERENCE`` on ``devices`` forced host devices."""
    return Job([sys.executable, "-c", REFERENCE, str(job_pkl), str(out_pkl)], out_pkl,
               _env(JAX_PLATFORMS="cpu",
                    XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}"))


# The reference's side, from a pickled job: ``pipe`` (GPipe over ('pod',
# 'model') = (4, 2), its output and the gradients of sum(out ** 2)), ``psum``
# (``psum_int8`` under shard_map over 4 devices, each device's slice of the
# leading axis) and ``archs`` (two train steps on each ('data', 'model') mesh
# of ``meshes``, [(output key, (data, model), head-aware rules)], by default
# (2, 2) without the head-aware rules, jitted with in/out shardings as
# launch/train.py does; the second with accum_steps=2, int8 compression and
# grad_shardings).
REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.base import get_config
from repro.launch import steps
from repro.models.model import Model
from repro.optim import adamw
from repro.parallel import context as pctx
from repro.parallel import sharding as sh
from repro.parallel.collectives import psum_int8
from repro.parallel.pipeline import pipeline_apply

job = pickle.load(open(sys.argv[1], "rb"))
out = {}
devs = np.array(jax.devices())
if "pipe" in job:
    mesh = Mesh(devs[:8].reshape(4, 2), ("pod", "model"))
    pp = {k: jnp.asarray(v) for k, v in job["pipe"]["params"].items()}
    x = jnp.asarray(job["pipe"]["x"])
    stage_fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
    run = lambda p, xs: pipeline_apply(stage_fn, p, xs, mesh=mesh, axis="pod")
    with mesh:
        o = jax.jit(run)(pp, x)
        g = jax.jit(jax.grad(lambda p, xs: (run(p, xs) ** 2).sum()))(pp, x)
    out["pipe"] = {"out": np.asarray(o), "grads": {k: np.asarray(v) for k, v in g.items()}}
if "psum" in job:
    m4 = Mesh(devs[:4], ("i",))
    out["psum"] = {}
    for name, xs in job["psum"].items():
        f = jax.shard_map(lambda a: psum_int8(a[0], "i")[None], mesh=m4, in_specs=P("i"),
                          out_specs=P("i"), check_vma=False)
        out["psum"][name] = np.asarray(jax.jit(f)(jnp.asarray(xs)).astype(jnp.float32))[0]
for key, (d, t), head_aware in job.get("meshes", [("train", (2, 2), False)]):
    mesh = Mesh(devs[:d * t].reshape(d, t), ("data", "model"))
    out[key] = {}
    for arch in job.get("archs", ()):
        cfg = get_config(arch).reduced()
        model = Model(cfg)
        opt = adamw.AdamWConfig(lr=job["lr"])
        params = model.init(jax.random.key(0))
        state = adamw.init_state(opt, params)
        rules_cfg = cfg if head_aware else None
        p_sh = sh.params_sharding(params, mesh, cfg=rules_cfg)
        o_sh = sh.opt_state_sharding(state, params, mesh, cfg=rules_cfg)
        params = jax.tree.map(jax.device_put, params, p_sh)
        state = jax.tree.map(jax.device_put, state, o_sh)
        pctx.install(("data",), tp_size=t, sp_seq=False)
        metrics = []
        for i, batch in enumerate(job["batches"][arch]):
            kw = dict(accum_steps=2, grad_compression="int8", grad_shardings=p_sh) if i else {}
            abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch)
            jitted = jax.jit(steps.make_train_step(model, opt, **kw),
                             in_shardings=(p_sh, o_sh, sh.batch_sharding(abstract, mesh)),
                             out_shardings=(p_sh, o_sh, None))
            with mesh:
                params, state, m = jitted(params, state,
                                          {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        pctx.clear()
        leaves = (jax.tree.leaves(params) + jax.tree.leaves(state["m"])
                  + jax.tree.leaves(state["v"]))
        out[key][arch] = (metrics, [np.asarray(a) for a in leaves])
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def main(path):
    with open(path) as f:
        job = json.load(f)
    mp.start_processes(_rank, args=(job["world"], job), nprocs=job["world"],
                       start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])

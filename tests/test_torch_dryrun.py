"""The port's dry run (``repro_torch.launch.dryrun``), its HLO-text parser
(``repro_torch.core.hlo_features``) and its sharding tuner
(``repro_torch.core.sharding_tuner``), held against the reference's.

The parser is an own copy: every field of ``CollectiveStats`` and
``HloFeatures`` equals the reference's on ``TestHloParsing.HLO`` of
``tests/test_distribution.py`` and on the post-compile HLO text of a small
jitted step with collectives and a loop, compiled in a subprocess on 8
forced host devices.

``run_cell`` traces the real step on meta tensors over a fake process group
(process-global), so every cell runs in a subprocess (``PORT``), as the
reference's ``MINI_DRYRUN`` does; the reference's three mini cells run in
another (``REFERENCE``), both started at once by the ``runs`` fixture.
Against the reference on its mini cells (reduced configs at ``train_4k``),
``status``, ``n_devices``, ``mesh``, ``accum_steps``, ``opt_state_dtype``
and ``mem.argument_bytes`` are equal. The collectives differ by kind:
each block part of the port is a region that states its collectives
(``parallel/context.region``): attention gathers the sequence and
reduce-scatters its output onto the sequence shards, the MLP gathers its
weights (their gradients reduce-scattered), the loss is vocab-parallel,
and the remat recompute issues none of the forward's collectives again;
XLA's partitioner all-reduces instead. Scaled bytes per device, port
against reference (on the CPU, torch 2.13 and jax 0.9), operand | link:

  yi_6b 2x4:        all-gather 2.307e8 / 3.125e8 | 6.501e8 / 8.725e8,
                    all-reduce 2.425e6 / 5.120e8 | 3.555e6 / 7.407e8,
                    reduce-scatter 7.256e8 / 0 | 5.337e8 / 0, all-to-all 0
                    / 2.621e6 | 0 / 1.311e6; total 9.587e8 / 8.272e8
                    (1.16x) | 1.187e9 / 1.614e9 (0.74x)
  yi_6b 2x2x2:      all-gather 2.186e8 / 3.010e8 | the same, all-reduce
                    1.964e7 / 2.702e8 | 1.964e7 / 2.723e8, reduce-scatter
                    3.639e8 / 0 | 1.819e8 / 0, all-to-all 0 / 1.573e6 | 0
                    / 1.180e6; total 6.021e8 / 5.728e8 (1.05x) | 4.202e8 /
                    5.745e8 (0.73x)
  qwen3-moe 2x4:    all-gather 9.219e8 / 1.021e9 | 2.694e9 / 2.103e9,
                    all-reduce 1.083e7 / 1.951e9 | 1.196e7 / 2.603e9,
                    reduce-scatter 9.691e8 / 0 | 7.195e8 / 0, all-to-all
                    8.389e6 / 2.621e6 | 6.291e6 / 1.311e6, permute 0 /
                    2.048e3 | 0 / 2.048e3; total 1.910e9 / 2.974e9 (0.64x)
                    | 3.432e9 / 4.708e9 (0.73x)

(Before the regions: 3.31x, 2.67x and 1.12x of the operand bytes.) The
test holds both totals within ``TOTAL_RATIO`` (0.5x to 2x) of the
reference's, qwen3-moe's within ``MOE_RATIO``.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import test_distribution as jdist
from repro.core import hlo_features as jhlo
from repro.core import sharding_tuner as jtuner
from repro.launch import specs as jspecs
from repro_torch.core import hlo_features as hlo
from repro_torch.core import sharding_tuner as tuner
from repro_torch.hw.gpu_h100 import HBM_BYTES
from repro_torch.parallel import context as pctx

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT = 600
TOTAL_RATIO = (0.5, 2.0)
# qwen3-moe's cell: the MoE's token gather (models/moe.py) keeps its region
MOE_RATIO = 1.15
MINI_CELLS = {"yi_6b 2x4": ("yi_6b", {"data": 2, "model": 4}),
              "yi_6b 2x2x2": ("yi_6b", {"pod": 2, "data": 2, "model": 2}),
              "qwen3_moe 2x4": ("qwen3_moe_235b_a22b", {"data": 2, "model": 4})}
# reduced xlstm-1.3b's cell on 2x4, with ``mixer_shard_map`` off and on, at a
# short train shape that both packages run (the reference's registered in
# its subprocess's ``specs.SHAPES``): the port traces the mixers' Python
# loops op by op on meta tensors, and ``train_4k``'s 4096 tokens took it
# tens of minutes. Two rows a microbatch, so each DP rank holds one, as at
# ``train_4k``'s 128 microbatches of 2.
XLSTM_SPEC = {"kind": "train", "seq": 64, "batch": 2}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


# --------------------------------------------------------------------------
# the HLO-text parser
# --------------------------------------------------------------------------


def _stats_equal(a, b):
    assert a.counts == b.counts
    assert a.operand_bytes == b.operand_bytes
    assert a.link_bytes == b.link_bytes


def _parity(text):
    _stats_equal(hlo.parse_collectives(text), jhlo.parse_collectives(text))
    _stats_equal(hlo.loop_scaled_collectives(text), jhlo.loop_scaled_collectives(text))
    got, want = hlo.parse_hlo(text), jhlo.parse_hlo(text)
    _stats_equal(got.collectives, want.collectives)
    assert (got.n_fusions, got.n_dots, got.n_layout_ops, got.n_while) == \
        (want.n_fusions, want.n_dots, want.n_layout_ops, want.n_while)
    assert hlo.collective_bytes(text) == jhlo.collective_bytes(text)
    assert hlo._split_computations(text) == jhlo._split_computations(text)


def test_parser_equals_the_reference_s_on_its_cell():
    _parity(jdist.TestHloParsing.HLO)
    st = hlo.loop_scaled_collectives(jdist.TestHloParsing.HLO)
    assert st.counts["all-reduce"] == 13  # 12 trips of the body and one more
    assert hlo.COLLECTIVE_KINDS == jhlo.COLLECTIVE_KINDS
    assert hlo._DTYPE_BYTES == jhlo._DTYPE_BYTES


@pytest.mark.parametrize("kind", hlo.COLLECTIVE_KINDS)
@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_one_ring_model_is_the_reference_s_formula(kind, group):
    """``ring_bytes`` (the parser's and the dry run's one ring model) gives
    the reference parser's operand and link bytes for one collective of
    each kind: an HLO line of a 4096-byte result over ``group`` devices."""
    line = f"%c = f32[32,32]{{1,0}} {kind}(%x), replica_groups=[{8 // min(group, 8)},{group}]<=[8]\n"
    want = jhlo.parse_collectives(line)
    assert want.counts[kind] == 1
    assert hlo.ring_bytes(kind, 4096.0, group) == (want.operand_bytes[kind],
                                                   want.link_bytes[kind])


def test_parser_equals_the_reference_s_on_a_compiled_step(runs):
    """The post-compile HLO text of a jitted step (a sharded matmul summed
    over both mesh axes inside a fori_loop of 3 trips, on 2x4 forced host
    devices): both parsers agree field for field, and it has collectives
    and a while loop to count."""
    text = runs["reference"].result()["hlo"]
    _parity(text)
    st = hlo.loop_scaled_collectives(text)
    assert sum(st.counts.values()) > 0 and hlo.parse_hlo(text).n_while >= 1


# --------------------------------------------------------------------------
# pick_accum_steps and the sharding tuner (no process group needed)
# --------------------------------------------------------------------------


MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"model": 8}]


def _jpick(batch, seq, mesh):
    """The reference's ``pick_accum_steps``, read from its source: importing
    ``repro.launch.dryrun`` forces 512 host devices into this process's
    XLA flags, so the function is run from its own text."""
    import ast

    from repro.launch import mesh as jmesh

    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "pick_accum_steps")
    ns = {"mesh_mod": jmesh}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), ns)
    return ns["pick_accum_steps"](batch, seq, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m.values())))
def test_pick_accum_steps_equals_the_reference_s(mesh):
    """On every stand-in mesh, at every shape of ``SHAPES`` and a few other
    batches and lengths."""
    from repro_torch.launch.dryrun import pick_accum_steps

    fake = FakeMesh(mesh)
    cells = [(s["batch"], s["seq"]) for s in jspecs.SHAPES.values()]
    cells += [(2, 2048), (8, 64), (96, 512), (1024, 4096), (256, 8192)]
    for batch, seq in cells:
        assert pick_accum_steps(batch, seq, fake) == _jpick(batch, seq, fake), (batch, seq)


def test_default_space_equals_the_reference_s():
    for kind in ("train", "prefill", "decode"):
        for base in (1, 2, 16, 64):
            assert tuner.default_space(kind, base) == jtuner.default_space(kind, base)
    space = tuner.default_space("train", base_accum=16)
    assert {"accum_steps", "grad_compression", "sp_seq"} <= set(space[0])
    assert len(space) >= 8


def _stand_ins():
    """A stand-in ``run_cell`` (a record whose memory and collectives
    depend on the variant, one variant refusing to trace) and
    ``structural_terms`` (the three roofline terms from the record)."""
    calls = []

    def run_cell_fn(arch, shape, variant=None, verbose=True):
        calls.append(dict(variant))
        a = variant.get("accum_steps", 1)
        if a == 32 and variant.get("grad_compression") == "int8":
            raise RuntimeError("this variant does not trace")
        temp = 90 * 2**30 // a + (2**30 if variant.get("sp_seq") else 0)
        coll = 1e9 * (0.5 if variant.get("grad_compression") else 1.0) * (1 + a / 64)
        return {"status": "ok", "mem": {"temp_bytes": temp, "argument_bytes": 3 * 2**30},
                "coll": coll, "accum": a}

    def structural_terms_fn(arch, shape, record):
        return {"compute_s": 0.2 + 0.01 * record["accum"], "memory_s": 0.1,
                "collective_s": record["coll"] / 4e10}

    return run_cell_fn, structural_terms_fn, calls


def test_tune_distribution_ranks_as_the_reference_does(monkeypatch):
    """The same stand-ins through both tuners, the reference's
    ``HBM_BYTES`` set to the H100's 80 GiB (the port's): the same variants
    in the same order, the same costs and terms, the same best, the
    refused variant at infinite cost in both; and with the reference's
    own 16 GiB the overflow penalty reorders it."""
    monkeypatch.setattr(jtuner, "HBM_BYTES", HBM_BYTES)
    assert tuner.HBM_BYTES == 80 * 2**30
    run, terms, calls = _stand_ins()
    best, results = tuner.tune_distribution("yi_6b", "train_4k", run, terms, base_accum=16)
    jbest, jresults = jtuner.tune_distribution("yi_6b", "train_4k", run, terms, base_accum=16)
    assert [r.variant for r in results] == [r.variant for r in jresults]
    assert [r.cost for r in results] == [r.cost for r in jresults]
    assert [r.terms for r in results] == [r.terms for r in jresults]
    assert best.variant == jbest.variant and best.cost == jbest.cost
    refused = [r for r in results if r.cost == float("inf")]
    assert len(refused) == 2 and all(r.record["status"] == "error" for r in refused)
    assert calls[:16] == calls[16:] and len(calls) == 32
    order = sorted(range(len(results)), key=lambda i: results[i].cost)
    monkeypatch.setattr(jtuner, "HBM_BYTES", 16 * 2**30)
    _, small = jtuner.tune_distribution("yi_6b", "train_4k", run, terms, base_accum=16)
    assert sorted(range(len(small)), key=lambda i: small[i].cost) != order


def test_evaluate_variant_penalises_overflow_past_the_h100():
    run, terms, _ = _stand_ins()
    r = tuner.evaluate_variant("a", "s", {"accum_steps": 1}, run, terms)
    peak = 90 * 2**30 + 3 * 2**30
    assert r.terms["hbm_peak_gib"] == peak / 2**30
    assert r.cost == pytest.approx(max(r.terms["compute_s"], r.terms["memory_s"],
                                       r.terms["collective_s"])
                                   + tuner.OVERFLOW_LAMBDA * (peak - HBM_BYTES))


# --------------------------------------------------------------------------
# run_cell (subprocesses)
# --------------------------------------------------------------------------

# The port's side: a JSON job of cells and checks on argv, its results as
# JSON on the last line of stdout.
PORT = textwrap.dedent(r"""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun, steps

    job = json.loads(sys.argv[1])
    out = {}
    for name, c in job.get("cells", {}).items():
        cfg = get_config(c["arch"]).reduced() if c.get("reduced") else None
        if c.get("layers"):  # full widths, cut in depth
            cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
        out[name] = dryrun.run_cell(c["arch"], c["shape"], mesh=c.get("mesh"), cfg=cfg,
                                    verbose=False, variant=c.get("variant"),
                                    spec=c.get("spec"))
    if job.get("trip"):
        cfg = get_config("yi_6b").reduced()
        spec = {"kind": "train", "seq": 32, "batch": 8}
        make = steps.make_train_step
        every = lambda *a, microbatch_loop=None, **kw: make(*a, **kw)
        out["trip"] = {}
        for a in (2, 4):
            one = dryrun.run_cell("yi_6b", "train_4k", mesh={"data": 2, "model": 2}, cfg=cfg,
                                  verbose=False, variant={"accum_steps": a}, spec=spec)
            dryrun.steps_mod.make_train_step = every
            try:
                full = dryrun.run_cell("yi_6b", "train_4k", mesh={"data": 2, "model": 2},
                                       cfg=cfg, verbose=False, variant={"accum_steps": a},
                                       spec=spec)
            finally:
                dryrun.steps_mod.make_train_step = make
            out["trip"][a] = (one, full)
    if job.get("attribute"):
        # each collective of reduced yi-6b's 2x4 step: its kind, its result's
        # shape, the innermost frame of the port's models that issued it, and
        # whether the remat recompute issued it
        import traceback
        issued = []
        collective = dryrun.StepTrace._collective

        def attributed(self, kind, out, group):
            stack = traceback.extract_stack()
            models = [f for f in stack if "repro_torch/models/" in f.filename]
            where = (f"{models[-1].filename.split('repro_torch/')[1]}:{models[-1].name}"
                     if models else "")
            recompute = any(f.name == "recompute_fn" and f.filename.endswith("checkpoint.py")
                            for f in stack)
            issued.append({"kind": kind, "shapes": [list(t.shape) for t in dryrun._tensors(out)],
                           "where": where, "recompute": recompute})
            collective(self, kind, out, group)

        dryrun.StepTrace._collective = attributed
        try:
            dryrun.run_cell("yi_6b", "train_4k", mesh={"data": 2, "model": 4},
                            cfg=get_config("yi_6b").reduced(), verbose=False)
        finally:
            dryrun.StepTrace._collective = collective
        out["attribute"] = issued
    if job.get("alltoall"):
        import torch.distributed as dist
        from torch.distributed.tensor import Shard
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.parallel import sharding as sh
        with dryrun.fake_world(4):
            mesh = mesh_mod.make_mesh((4,), ("model",), device="cpu")
            x = sh.placed_zeros((64, 32), torch.float32, [Shard(0)], mesh, "meta")
            with dryrun.StepTrace() as t:
                y = x.redistribute(mesh, [Shard(1)])
            out["alltoall"] = {"counts": t.counts, "operand": t.operand,
                               "local": list(y.to_local().shape)}
            try:
                dryrun.run_cell("yi_6b", "decode_32k", mesh={"model": 4},
                                cfg=get_config("yi_6b").reduced(), verbose=False)
                out["refused"] = False
            except RuntimeError as e:
                out["refused"] = "initialised already" in str(e)
        out["group_after"] = dist.is_initialized()
        dryrun.run_cell("yi_6b", "decode_32k", mesh={"model": 4},
                        cfg=get_config("yi_6b").reduced(), verbose=False)
        out["group_after_run"] = dist.is_initialized()
    print(json.dumps(out, default=float))
""")

# The reference's side: its three mini cells (tests/test_distribution.py's
# MINI_DRYRUN) and the HLO text of a small jitted step, on 8 forced host
# devices.
REFERENCE = textwrap.dedent(r"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config
    from repro.launch import mesh as mesh_mod
    from repro.launch.dryrun import run_cell

    job = json.loads(sys.argv[1])
    out = {}
    for name, (arch, mesh) in job["cells"].items():
        m = mesh_mod.make_mesh(tuple(mesh.values()), tuple(mesh))
        out[name] = run_cell(arch, "train_4k", mesh=m, cfg=get_config(arch).reduced(),
                             verbose=False)
    m = mesh_mod.make_mesh((2, 4), ("data", "model"))
    if job.get("xlstm"):
        # the xlstm cell's short shape, registered in this process only
        from repro.launch import specs
        name, spec = job["xlstm"]
        specs.SHAPES[name] = spec
        out["xlstm"] = {str(key): run_cell("xlstm_13b", name, mesh=m,
                                           cfg=get_config("xlstm_13b").reduced(),
                                           verbose=False, variant={"mixer_shard_map": key})
                        for key in (False, True)}

    def step(x, w):
        def body(i, acc):
            y = jnp.tanh(x @ w + i)
            return acc + jax.lax.with_sharding_constraint(y, NamedSharding(m, P())).sum()
        return jax.lax.fori_loop(0, 3, body, jnp.zeros((), x.dtype))

    xs = jax.ShapeDtypeStruct((64, 32), jnp.float32, sharding=NamedSharding(m, P("data")))
    ws = jax.ShapeDtypeStruct((32, 128), jnp.float32, sharding=NamedSharding(m, P(None, "model")))
    out["hlo"] = jax.jit(step).lower(xs, ws).compile().as_text()
    print(json.dumps(out, default=float))
""")


class _Proc:
    def __init__(self, code, job, env):
        self.proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(job)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, env=env)
        self._out = None

    def result(self):
        if self._out is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, err = self.proc.communicate()
                raise AssertionError(f"timed out after {TIMEOUT} s: {err[-3000:]}")
            assert self.proc.returncode == 0, err[-3000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _env(**extra):
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs():
    port_cells = {name: {"arch": arch, "shape": "train_4k", "mesh": mesh, "reduced": True}
                  for name, (arch, mesh) in MINI_CELLS.items()}
    port_cells["long"] = {"arch": "yi_6b", "shape": "long_500k", "reduced": True}
    port_cells["decode 16x16"] = {"arch": "yi_6b", "shape": "decode_32k"}
    port_cells["card 1x1"] = {"arch": "yi_6b", "shape": "train_4k", "reduced": True,
                              "mesh": {"data": 1, "model": 1},
                              "variant": {"state_dtype": "bfloat16", "accum_steps": 1},
                              "spec": {"kind": "train", "seq": 64, "batch": 2}}
    for sp in (False, True):
        port_cells[f"yi_6b 2x2 16k sp={sp}"] = {
            "arch": "yi_6b", "shape": "train_4k", "layers": 2, "mesh": {"data": 2, "model": 2},
            "variant": {"sp_seq": sp, "accum_steps": 1},
            "spec": {"kind": "train", "seq": 4096, "batch": 8}}
    xlstm_cells = {f"xlstm key={key}": {
        "arch": "xlstm_13b", "shape": "train_4k", "reduced": True,
        "mesh": {"data": 2, "model": 4}, "variant": {"mixer_shard_map": key},
        "spec": XLSTM_SPEC} for key in (False, True)}
    jobs = {
        "reference": _Proc(REFERENCE, {"cells": MINI_CELLS, "xlstm": ("train_64", XLSTM_SPEC)},
                           _env(JAX_PLATFORMS="cpu")),
        "port": _Proc(PORT, {"cells": port_cells}, _env()),
        "xlstm": _Proc(PORT, {"cells": xlstm_cells}, _env()),
        "checks": _Proc(PORT, {"trip": True, "alltoall": True, "attribute": True}, _env()),
    }
    yield jobs
    for job in jobs.values():
        job.kill()


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_run_cell_matches_the_reference_on_its_mini_cells(runs, cell):
    """Status, devices, mesh, accumulation, optimizer-state dtype and the
    per-device argument bytes equal; the record has every key of the
    reference's; the total scaled collective operand bytes within
    ``TOTAL_RATIO`` of the reference's (the module docstring's table)."""
    got, want = runs["port"].result()[cell], runs["reference"].result()[cell]
    for key in ("status", "n_devices", "mesh", "accum_steps", "opt_state_dtype", "variant"):
        assert got[key] == want[key], key
    assert got["status"] == "ok"
    assert got["mem"]["argument_bytes"] == want["mem"]["argument_bytes"]
    assert set(got) == set(want) and set(got["mem"]) == set(want["mem"])
    assert got["compile_s"] == 0.0 and got["mem"]["code_bytes"] == 0
    for key in ("collective_counts", "collective_operand_bytes_scaled"):
        assert set(got[key]) == set(want[key]) == set(hlo.COLLECTIVE_KINDS)
    top = MOE_RATIO if cell.startswith("qwen3_moe") else TOTAL_RATIO[1]
    for key in ("collective_operand_bytes_scaled", "collective_link_bytes_scaled"):
        ratio = sum(got[key].values()) / sum(want[key].values())
        assert TOTAL_RATIO[0] <= ratio <= top, (key, ratio)
    for kind in hlo.COLLECTIVE_KINDS:
        scaled, once = got["collective_counts_scaled"][kind], got["collective_counts"][kind]
        assert scaled >= once
        op, link = got["collective_operand_bytes_scaled"][kind], got["collective_link_bytes_scaled"][kind]
        assert (op > 0) == (scaled > 0) and link >= 0


def _total(record, key):
    return sum(record[key].values())


@pytest.mark.parametrize("key", [False, True])
def test_xlstm_mixer_shard_map_follows_the_reference(runs, key):
    """The xlstm cell with ``mixer_shard_map`` off (XLA's partitioner in the
    reference; the port's sLSTM product on ``r``'s model shards) and on
    (``shard_map``): status, devices, mesh, accumulation, optimizer-state
    dtype, variant and argument bytes equal, and the scaled all-reduce
    count and the total scaled collective operand bytes within
    ``TOTAL_RATIO`` of the reference's. Both sum the sLSTM's recurrent
    weights' gradients over the DP axes at every time step (the module
    docstring of ``models/xlstm.py``)."""
    got = runs["xlstm"].result()[f"xlstm key={key}"]
    want = runs["reference"].result()["xlstm"][str(key)]
    for name in ("status", "n_devices", "mesh", "accum_steps", "opt_state_dtype", "variant"):
        assert got[name] == want[name], name
    assert got["status"] == "ok"
    assert got["mem"]["argument_bytes"] == want["mem"]["argument_bytes"]
    ratio = (got["collective_counts_scaled"]["all-reduce"]
             / want["collective_counts_scaled"]["all-reduce"])
    assert TOTAL_RATIO[0] <= ratio <= TOTAL_RATIO[1], ratio
    ratio = (_total(got, "collective_operand_bytes_scaled")
             / _total(want, "collective_operand_bytes_scaled"))
    assert TOTAL_RATIO[0] <= ratio <= TOTAL_RATIO[1], ratio


def test_xlstm_without_the_key_all_reduces_more(runs):
    """Without ``mixer_shard_map`` both packages issue more all-reduces
    than with it: one more a time step, over ``model`` (the state's
    gradient, where the step's product runs on ``r``'s model shards)."""
    got, want = runs["xlstm"].result(), runs["reference"].result()["xlstm"]
    count = lambda r: r["collective_counts_scaled"]["all-reduce"]
    assert count(want["False"]) > count(want["True"])
    assert count(got["xlstm key=False"]) > count(got["xlstm key=True"])


def test_the_loss_gathers_no_logits_and_the_recompute_no_collective(runs):
    """Each collective of reduced yi-6b's step on 2x4 (``train_4k``),
    attributed to the innermost frame of ``repro_torch/models`` that issued
    it: the cross-entropy issues no all-gather of a [B, c, V] tensor (its
    logits stay sharded over the vocab; it gathers only each rank's
    logsumexp and gold logit per position), and the remat recompute
    issues no collective (the forward's are kept, ``layers.remat``); the
    attention's and the MLP's regions issue collectives, the MLP's only of
    its weights (weight-gathered at this size, ``pctx.pick_layout``)."""
    issued = runs["checks"].result()["attribute"]
    vocab = 256
    loss = [c for c in issued if c["where"].startswith("models/layers.py:")
            and "loss" in c["where"]]
    assert loss and not [c for c in loss if c["kind"] == "all-gather"
                         and any(len(sh) == 3 and sh[-1] == vocab for sh in c["shapes"])]
    assert not [c for c in issued if c["recompute"]]
    where = {c["where"] for c in issued}
    assert "models/attention.py:attention_forward" in where
    mlp = [c for c in issued if c["where"] == "models/layers.py:apply_dense_mlp"]
    assert mlp and all(len(sh) == 2 for c in mlp for sh in c["shapes"])  # weights only


@pytest.mark.parametrize("case, layout", [
    ("reduced yi-6b MLP, 2x4", pctx.WEIGHT_GATHERED),
    ("yi-6b MLP, 16x16", pctx.TOKEN_GATHERED),
    ("yi-6b MLP, 16x16, whole sequence", pctx.TOKEN_GATHERED),
    ("reduced yi-6b MLP, 1x1", pctx.TOKEN_GATHERED),
    ("reduced yi-6b MLP, 2x4, no sequence parallelism", pctx.TOKEN_GATHERED),
    ("yi-6b MLP, 2x2, 16k tokens, no sequence parallelism", pctx.TOKEN_GATHERED)])
def test_pick_layout_moves_the_smaller_operand(case, layout):
    """Shapes only: reduced yi-6b's MLP (3 x 64 x 128 f32, 96 KiB) on 2x4
    at ``train_4k``'s microbatch (1 row x 1024 sequence positions per
    rank, its activations 1 MiB gathered) gathers its weights; yi-6b's
    (3 x 4096 x 11008 bf16, 258 MiB) on 16x16 (1 row x 256 positions, 32
    MiB gathered; or 4096 positions, whole, as a prefill without sequence
    parallelism) gathers its tokens; a one-rank ``model`` axis moves
    nothing either way and keeps the tokens. Without sequence parallelism
    (the trainer's ``--mesh``) the tokens are whole on every ``model``
    rank and stay gathered, whatever the sizes: the weight-gathered
    layout would run the whole MLP on each rank (yi-6b at 16k tokens per
    data rank, 128 MiB of activations, would pick it by bytes alone)."""
    reduced, full = [(64, 128), (64, 128), (128, 64)], [(4096, 11008)] * 2 + [(11008, 4096)]
    args = {"reduced yi-6b MLP, 2x4": (reduced, 64, 1024, {"data": 2, "model": 4}, True,
                                       torch.float32),
            "yi-6b MLP, 16x16": (full, 4096, 256, {"data": 16, "model": 16}, True,
                                 torch.bfloat16),
            "yi-6b MLP, 16x16, whole sequence": (full, 4096, 4096,
                                                 {"data": 16, "model": 16}, False,
                                                 torch.bfloat16),
            "reduced yi-6b MLP, 1x1": (reduced, 64, 1024, {"data": 1, "model": 1}, True,
                                       torch.float32),
            "reduced yi-6b MLP, 2x4, no sequence parallelism": (
                reduced, 64, 4096, {"data": 2, "model": 4}, False, torch.float32),
            "yi-6b MLP, 2x2, 16k tokens, no sequence parallelism": (
                full, 4096, 16384, {"data": 2, "model": 2}, False, torch.bfloat16)}[case]
    weights, d, tokens, mesh, sp, dtype = args
    assert pctx.pick_layout(weights, d, tokens, FakeMesh(mesh), sp, dtype) == layout


def test_without_sequence_parallelism_each_token_runs_the_mlp_once(runs):
    """yi-6b at full width, two layers, on 2x2, 8 x 4096 tokens in one
    microbatch (16k per data rank): the step's flops without sequence
    parallelism (the trainer's ``--mesh``) equal those with it. Picked by
    link bytes alone, the MLPs would gather their weights and run whole on
    both ``model`` ranks, 5.903e13 flops a step against 4.278e13."""
    got = runs["port"].result()
    off, on = got["yi_6b 2x2 16k sp=False"], got["yi_6b 2x2 16k sp=True"]
    assert off["status"] == on["status"] == "ok"
    assert off["hlo_flops"] == pytest.approx(on["hlo_flops"], rel=1e-9)


def test_full_attention_skips_long_500k_and_the_production_decode_runs(runs):
    got = runs["port"].result()
    assert got["long"]["status"] == "skipped" and "full-attention" in got["long"]["why"]
    dec = got["decode 16x16"]
    assert dec["status"] == "ok" and dec["n_devices"] == 256
    assert dec["mesh"] == {"data": 16, "model": 16}
    # yi-6b's 4 key heads do not divide 16: the cache is split by position
    # over ``model``, and each layer all-reduces the softmax's max, sum and
    # output over it (flash decoding)
    assert dec["collective_counts"]["all-reduce"] >= 3 * 32
    assert 0 < dec["mem"]["argument_bytes"] < HBM_BYTES


def test_one_rank_cell_counts_no_collective_and_the_whole_state(runs):
    """A 1x1 cell (the card's own, at reduced size): no collective, and the
    arguments are the whole parameters, bf16 moments and batch; the
    parameters and moments come back as the same storages (aliased)."""
    rec = runs["port"].result()["card 1x1"]
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert sum(rec["collective_counts"].values()) == 0
    assert rec["mem"]["temp_bytes"] > 0 and rec["hlo_flops"] > 0
    assert rec["mem"]["alias_bytes"] <= rec["mem"]["output_bytes"]
    assert rec["mem"]["argument_bytes"] - rec["mem"]["alias_bytes"] == 2 * 2 * 64 * 4


@pytest.mark.parametrize("accum", [2, 4])
def test_one_microbatch_scaled_equals_every_microbatch_traced(runs, accum):
    """The step with ``accum`` microbatches, one traced and scaled by the
    trip count, against all of them traced (reduced yi-6b, 2x2, 8 x 32
    tokens): every collective count and byte and the flops equal. The
    bytes moved and the peak differ by what the first microbatch does once
    (the RoPE tables it makes): within 5% and 1%. Unscaled, the one-body
    trace counts fewer collectives."""
    one, full = runs["checks"].result()["trip"][str(accum)]
    for key in ("collective_counts_scaled", "collective_operand_bytes_scaled",
                "collective_link_bytes_scaled", "hlo_flops"):
        assert one[key] == full[key], key
    assert one["hlo_bytes"] == pytest.approx(full["hlo_bytes"], rel=0.05)
    assert one["mem"]["temp_bytes"] == pytest.approx(full["mem"]["temp_bytes"], rel=0.01)
    assert sum(one["collective_counts"].values()) < sum(full["collective_counts"].values())
    assert full["collective_counts"] == full["collective_counts_scaled"]


def test_shard_to_shard_counts_as_one_all_to_all(runs):
    """An S(0) -> S(1) redistribution over 4 ranks is the one all-to-all the
    step asks for (a CPU group would all-gather and chunk instead, which
    would count as an all-gather): its result is the 16 x 32 -> 64 x 8
    shard, 2048 bytes of f32."""
    got = runs["checks"].result()["alltoall"]
    assert got["local"] == [64, 8]
    assert got["counts"] == {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                             "all-to-all": 1, "collective-permute": 0}
    assert got["operand"]["all-to-all"] == 64 * 8 * 4


def test_run_cell_refuses_a_group_and_leaves_none(runs):
    """The fake group is process-global: ``run_cell`` refuses when one is
    initialised, and destroys its own on return."""
    got = runs["checks"].result()
    assert got["refused"] is True
    assert got["group_after"] is False and got["group_after_run"] is False


def test_cli_writes_records_under_build(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes one record per cell
    into ``--out`` (by default ``build/dryrun``, never ``experiments/``)."""
    from repro_torch.launch import dryrun

    assert Path(dryrun.OUT_DIR) == ROOT / "build" / "dryrun"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "yi_6b", "--shape", "long_500k", "--out", str(tmp_path)],
                          capture_output=True, text=True, env=_env(), timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads((tmp_path / "yi_6b_long_500k_pod.json").read_text())
    assert rec["status"] == "skipped" and rec["n_devices"] == 256
    assert "all requested cells passed" in proc.stdout

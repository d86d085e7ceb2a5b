"""The dry run (the port of ``repro.launch.dryrun``): one (arch x shape x
mesh) step traced on meta tensors on the host, recorded as the reference
records its compiled cells.

The dry run runs no step on any device, and never touches the card. The
reference lowers and compiles each cell for 256 or 512 forced host devices;
torch has no compiled HLO, so the port traces the real step of
``launch/steps.py`` once, eagerly, over a ``fake`` process group whose
world size is the mesh's (``torch.testing``'s ``FakeStore``; this process is
rank 0), on a ``DeviceMesh`` from ``launch/mesh.make_mesh`` on device
``"cpu"``, with every parameter, optimizer-state, cache and batch leaf a
``DTensor`` placed by ``parallel/sharding.py``'s rules whose local shard is
a meta tensor (shape and dtype, no storage), and the model on the meta
device (``specs.on_meta``). Meta tensors take the kernels' plain versions,
as the reference's host compile takes the jnp reference path, so no kernel
is launched. (Not a ``FakeTensorMode``: under one, DTensor's sharding
propagation reads the values of index tensors that a fake mode makes fake,
for the strided shards of a ``[B * S, D]`` view, and fails.)

What the trace records, under the reference's record keys (``StepTrace``
counts it on the local shards, below ``DTensor``, so every number is per
device):

* ``collective_*``: each collective the step issues
  (``torch.ops._c10d_functional``, and DTensor's shard-to-shard all-to-all,
  which a CPU group would replace by an all-gather and a chunk; the trace
  counts the all-to-all the step asks for), by kind
  (``core/hlo_features.COLLECTIVE_KINDS``), its result bytes and its
  group's size through the one ring model, ``hlo_features.ring_bytes``;
  ``wait_tensor`` is not counted, as the parser skips ``-done``.
* ``hlo_flops``: the flops of the local matmuls, convolutions and
  attention ops (``torch.utils.flop_counter``'s formulas on local shapes);
  ``hlo_bytes``: the bytes every local op that is not a view reads and
  writes, with no fusion (an upper bound of what a compiled step moves).
* ``mem``: ``argument_bytes``, the local shards of the parameters,
  optimizer state, batch and cache; ``temp_bytes``, the peak bytes of the
  storages the step allocates while it runs (its activations, gradients
  and collective buffers); ``output_bytes``, the step's outputs' local
  bytes, and ``alias_bytes``, those of them that are arguments updated in
  place; ``code_bytes`` is 0 (nothing is compiled).
* ``lower_s`` is the trace's seconds and ``compile_s`` is 0.0.

The trip count: with ``accum_steps`` microbatches the step runs one
microbatch inside ``StepTrace.loop`` (the step's ``microbatch_loop``), and
that microbatch's collectives and flops are multiplied by the trip count,
as ``hlo_features.loop_scaled_collectives`` scales a while body; the
unscaled ``collective_*`` keys count the body once, as the reference's
parse of the compiled text does. The once-only part (the gradient
placement, the optimizer, the norm's all-reduce) counts once either way.

Usage (the records go to ``build/dryrun/``; ``experiments/`` is the
reference's):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.hlo_features import COLLECTIVE_KINDS, ring_bytes
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as S
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as sh

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT_DIR = os.path.join(ROOT, "build", "dryrun")

# the collectives a step issues, by op name, and the kind each counts as
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def pick_accum_steps(batch: int, seq: int, mesh, target_tokens: int = 4096) -> int:
    """Gradient-accumulation microbatching: bound per-device microbatch
    tokens so the activations of a microbatch fit (the reference's rule)."""
    dp = mesh_mod.axis_size(mesh, mesh_mod.dp_axes(mesh))
    accum = 1
    while (
        (batch // accum) * seq // dp > target_tokens
        and batch % (accum * 2) == 0
        and (batch // (accum * 2)) % dp == 0
    ):
        accum *= 2
    return accum


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


@contextlib.contextmanager
def alltoall_as_asked():
    """DTensor's shard-to-shard redistribution as the step asks for it: one
    all-to-all (``_dtensor.shard_dim_alltoall``, whose fake version gives
    the shard on meta tensors), where a CPU group would all-gather and
    chunk."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    original = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group_name((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


class StepTrace(TorchDispatchMode):
    """Counts what a step does on this rank's local shards: collectives by
    kind (count, operand and link bytes, unscaled and scaled by the trip
    count of the loop they run in), flops, bytes moved, and the live bytes
    of the storages the step allocates, with their peak. DTensor ops are
    passed on (``NotImplemented``), so DTensor desugars them into the local
    ops and collectives that this mode then sees. While it is on, DTensor's
    shard-to-shard redistributions are the all-to-all a step asks for
    (``alltoall_as_asked``)."""

    def __init__(self):
        super().__init__()
        kinds = COLLECTIVE_KINDS
        self.counts = {k: 0 for k in kinds}
        self.operand = {k: 0.0 for k in kinds}
        self.link = {k: 0.0 for k in kinds}
        self.counts_scaled = {k: 0 for k in kinds}
        self.operand_scaled = {k: 0.0 for k in kinds}
        self.link_scaled = {k: 0.0 for k in kinds}
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._trips = 1
        self._known = WeakIdKeyDictionary()  # storages that are not the step's
        self._mine = WeakIdKeyDictionary()  # storages the step allocated

    def __enter__(self):
        self._asked = alltoall_as_asked()
        self._asked.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._asked.__exit__(*exc)

    def known(self, tensors) -> None:
        """Mark the storages of ``tensors`` (the arguments) as not the
        step's: an op that returns one (an in-place update, a view)
        allocates nothing."""
        for t in tensors:
            self._known[_local(t).untyped_storage()] = True

    @contextlib.contextmanager
    def loop(self, trips: int):
        """A loop body run once standing for ``trips`` runs."""
        prev, self._trips = self._trips, self._trips * trips
        try:
            yield
        finally:
            self._trips = prev

    def _collective(self, kind, out, group):
        nbytes = float(sum(t.nbytes for t in _tensors(out)))
        operand, link = ring_bytes(kind, nbytes, group)
        self.counts[kind] += 1
        self.operand[kind] += operand
        self.link[kind] += link
        self.counts_scaled[kind] += self._trips
        self.operand_scaled[kind] += operand * self._trips
        self.link_scaled[kind] += link * self._trips

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._known or st in self._mine:
                continue
            n = st.nbytes()
            self._mine[st] = True
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        # DTensor learns an output's global metadata by running the op on
        # fake tensors of the global shapes, on a fake mode of its own: no
        # work of the step
        if isinstance(func, torch._ops.HigherOrderOperator) or active_fake_mode() is not None:
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name == "wait_tensor":  # the buffer its collective returned
            return args[0]
        out = func(*args, **kwargs)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self._collective(kind, out, _group_size(kwargs.get("group_name", args[-1])))
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out) * self._trips
        if not func.is_view:
            moved = sum(t.nbytes for t in _tensors((args, kwargs)))
            moved += sum(t.nbytes for t in _tensors(out))
            self.bytes += moved * self._trips
        self._track(out)
        return out


def _tensors(obj):
    return [t for t in torch.utils._pytree.tree_leaves(obj) if isinstance(t, torch.Tensor)]


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _local_bytes(tensors) -> int:
    return int(sum(_local(t).nbytes for t in tensors))


@contextlib.contextmanager
def fake_world(n_devices: int):
    """A ``fake`` process group of ``n_devices`` ranks (this process rank
    0), destroyed on exit; refused when a group already exists, since the
    default group is process-global."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_devices)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_spec(mesh, multi_pod):
    """(shape, axes) of the cell's mesh: the production mesh's (``None``),
    a ``{axis: size}`` mapping's, or a ``DeviceMesh``'s."""
    if mesh is None:
        return mesh_mod.PRODUCTION_SHAPES[multi_pod]
    shape = dict(mesh) if isinstance(mesh, dict) else mesh_mod.shape_of(mesh)
    return tuple(shape.values()), tuple(shape)


def _placed_meta(shapes, placements_tree, mesh):
    """A tree of DTensors of ``shapes``' shapes and dtypes with the given
    placements, each local shard a meta tensor."""
    pl = tree.flatten_up_to(shapes, placements_tree)
    return tree.unflatten_like(shapes, [
        sh.placed_zeros(t.shape, t.dtype, p, mesh, S.META)
        for t, p in zip(tree.leaves(shapes), pl)])


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mesh=None,
    cfg=None,
    verbose: bool = True,
    variant: Optional[Dict[str, Any]] = None,
    spec: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Trace one cell; returns the reference's dry-run record.

    ``mesh`` is ``None`` (the production mesh, 16x16 or with ``multi_pod``
    2x16x16), a ``{axis: size}`` mapping, or a ``DeviceMesh`` on ``"cpu"``
    over a process group the caller made (else ``run_cell`` makes a fake
    group of the mesh's size and destroys it on return). ``variant``
    overrides the distribution knobs as the reference's does:
    accum_steps, grad_compression ("int8"), sp_seq (bool), state_dtype
    ("float32"|"bfloat16"|"int8"), grad_dtype, moe_pin, mixer_shard_map
    (bool: the mesh in the activation context, the xLSTM mixers' form;
    ``models/xlstm.py``), and the config's
    attn_chunk, ssm_chunk, mlstm_chunk and remat_stack. ``spec`` (``{kind,
    seq, batch}``) stands in for ``specs.SHAPES[shape_name]``, for a cell
    of another size (the card's own training run, in ``chip_smoke.py``).
    """
    from torch.distributed.device_mesh import DeviceMesh

    variant = variant or {}
    cfg = cfg or get_config(arch)
    cfg_over = {k: variant[k] for k in ("attn_chunk", "ssm_chunk",
                                        "mlstm_chunk", "remat_stack")
                if k in variant}
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    shape, axes = _mesh_spec(mesh, multi_pod)
    n_devices = 1
    for s in shape:
        n_devices *= int(s)
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": dict(zip(axes, (int(s) for s in shape))),
        "n_devices": n_devices,
    }
    ok, why = S.shape_applicable(cfg, shape_name)
    if not ok:
        record["status"] = "skipped"
        record["why"] = why
        return record
    world = (contextlib.nullcontext() if isinstance(mesh, DeviceMesh)
             else fake_world(n_devices))
    with world:
        dmesh = mesh if isinstance(mesh, DeviceMesh) else mesh_mod.make_mesh(
            shape, axes, device="cpu")
        _trace_cell(cfg, spec or S.SHAPES[shape_name], dmesh, variant, record)
    if verbose:
        m = record["mem"]
        counts = {k: v for k, v in record["collective_counts_scaled"].items() if v}
        print(f"[{arch} x {shape_name} x {record['mesh']}] trace ok "
              f"({record['lower_s']:.1f}s)\n"
              f"  memory/device: args={m['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
              f"alias={m['alias_bytes'] / 2**30:.2f}GiB\n"
              f"  flops={record['hlo_flops']:.3e} bytes={record['hlo_bytes']:.3e} "
              f"collective_operand={sum(record['collective_operand_bytes_scaled'].values()):.3e}B "
              f"counts={counts}")
    return record


def _trace_cell(cfg, spec, mesh, variant, record):
    from torch.distributed.tensor.experimental import implicit_replication

    kind, seq, batch = spec["kind"], spec["seq"], spec["batch"]
    model = S.on_meta(Model(cfg, device="cpu"))
    t0 = time.perf_counter()
    # the mesh in the context only with the variant's key, as the
    # reference's (its xLSTM mixers read it: ``models/xlstm.py``)
    pctx.install(mesh_mod.dp_axes(mesh), tp_axis="model",
                 tp_size=mesh_mod.axis_size(mesh, "model"),
                 sp_seq=variant.get("sp_seq", kind in ("train", "prefill")),
                 mesh=mesh if variant.get("mixer_shard_map", False) else None,
                 moe_pin=variant.get("moe_pin", False))
    trace = StepTrace()
    try:
        params_s = S.abstract_params(model)
        p_shard = sh.params_sharding(params_s, mesh, cfg=cfg)
        params = _placed_meta(params_s, p_shard, mesh)
        if kind == "train":
            state_dtype = variant.get("state_dtype", S.recommended_state_dtype(cfg))
            record["opt_state_dtype"] = state_dtype
            opt_cfg = adamw.AdamWConfig(state_dtype=state_dtype)
            opt_s = adamw.init_state(opt_cfg, params_s)
            opt_state = _placed_meta(
                opt_s, sh.opt_state_sharding(opt_s, params_s, mesh, cfg=cfg), mesh)
            batch_s = S.batch_specs(cfg, batch, seq)
            accum = variant.get("accum_steps", pick_accum_steps(batch, seq, mesh))
            record["accum_steps"] = accum
            record["variant"] = dict(variant)
            gd = variant.get("grad_dtype")

            def one_microbatch(mbs):
                with trace.loop(len(mbs)):
                    yield mbs[0]

            step = steps_mod.make_train_step(
                model, opt_cfg, accum_steps=accum, grad_shardings=p_shard,
                grad_compression=variant.get("grad_compression"),
                grad_dtype=getattr(torch, gd) if gd else None,
                microbatch_loop=one_microbatch if accum > 1 else None)
            # the step places each microbatch itself; the record counts
            # the batch's local shard, as the reference's in_shardings do
            args = (params, opt_state)
            arg_bytes = _local_bytes(tree.leaves(args)) + _local_bytes(
                tree.leaves(_placed_meta(batch_s, sh.batch_sharding(batch_s, mesh), mesh)))
            run = lambda: step(params, opt_state, batch_s)
        elif kind == "prefill":
            batch_s = S.infer_batch_specs(cfg, batch, seq)
            b = _placed_meta(batch_s, sh.batch_sharding(batch_s, mesh), mesh)
            cap = seq + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
            step = steps_mod.make_prefill_step(model, cap=cap)
            args = (params, b)
            arg_bytes = _local_bytes(tree.leaves(args))
            run = lambda: step(params, b)
        else:  # decode
            cache = model.init_cache(batch, seq, mesh=mesh)
            dspec = S.decode_specs(cfg, batch, seq)
            toks = _placed_meta({"t": dspec["tokens"]},
                                 sh.batch_sharding({"t": dspec["tokens"]}, mesh), mesh)["t"]
            pos = torch.zeros((), dtype=torch.int32, device=S.META)
            step = steps_mod.make_serve_step(model)
            args = (params, cache, toks)
            arg_bytes = _local_bytes(tree.leaves(args)) + pos.nbytes
            run = lambda: step(params, cache, toks, pos)
        trace.known(tree.leaves(args))
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        with trace, grad, implicit_replication():
            out = run()
        t_lower = time.perf_counter() - t0
        outs = [t for t in tree.leaves(out) if isinstance(t, torch.Tensor)]
        arg_storages = {id(_local(t).untyped_storage()) for t in tree.leaves(args)}
        alias = _local_bytes(t for t in outs
                             if id(_local(t).untyped_storage()) in arg_storages)
    finally:
        pctx.clear()
    record.update(
        status="ok",
        lower_s=round(t_lower, 2),
        compile_s=0.0,
        hlo_flops=trace.flops,
        hlo_bytes=trace.bytes,
        collective_counts=trace.counts,
        collective_operand_bytes=trace.operand,
        collective_link_bytes=trace.link,
        collective_operand_bytes_scaled=trace.operand_scaled,
        collective_link_bytes_scaled=trace.link_scaled,
        collective_counts_scaled=trace.counts_scaled,
        mem=dict(
            argument_bytes=arg_bytes,
            output_bytes=_local_bytes(outs),
            temp_bytes=trace.peak,
            alias_bytes=alias,
            code_bytes=0,
        ),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--schedule-db", default=None,
                    help="a schedule store (JSONL) for the kernels' block picks; "
                         "the dry run traces on the CPU, where the kernels take "
                         "their plain versions, so no pick is exercised")
    args = ap.parse_args(argv)

    if args.schedule_db:
        from repro_torch.kernels.ops import use_schedule_db

        use_schedule_db(args.schedule_db)
        print("[tuna] note: --schedule-db installed, but this dry run traces on "
              "the CPU, where kernels use their plain versions; block picks are "
              "not exercised")
    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(S.SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape_name}_{'multipod' if mp else 'pod'}"
                try:
                    rec = run_cell(arch, shape_name, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 — one cell's failure is recorded
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures.append(tag)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2, default=float)
    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print("all requested cells passed")


if __name__ == "__main__":
    main()

"""Fault-tolerant trainer (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

Deterministic resumable data, async atomic checkpoints with keep-k GC,
failure injection with bounded restarts (restore from the latest
checkpoint), straggler monitoring, heartbeats, gradient accumulation and
int8 gradient compression, as in the reference. The model is drawn from a
seeded ``torch.Generator`` on the device. Without ``--device cpu`` it runs
on the card and raises when there is none.

With a device mesh (``mesh_shape``, ``--mesh 2x4``: axes ``("data",
"model")``) the parameters and the optimizer state are ``DTensor``s placed
by ``parallel/sharding.py``'s rules, batches by ``batch_sharding``, and the
activation context is installed for the run, as in the reference. The
caller initialises the process group (``main`` does it for ``--mesh``:
``launch/mesh.init_process_group``, one rank on localhost unless a launcher
set ``WORLD_SIZE``); every rank runs ``train`` and rank 0 writes the
checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import elastic, store
from repro_torch.configs.base import get_config
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticConfig, SyntheticTokens
from repro_torch.hw import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.failure import FailureInjector, InjectedFailure, RestartPolicy
from repro_torch.runtime.straggler import Heartbeat, StragglerMonitor


@dataclasses.dataclass
class TrainOptions:
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    keep: int = 3
    accum_steps: int = 1
    grad_compression: Optional[str] = None
    state_dtype: str = "float32"
    lr: float = 3e-4
    seed: int = 0
    mesh_shape: Optional[tuple] = None  # e.g. (2, 4) -> ('data', 'model')
    log_every: int = 10
    device: str = "cuda"


def build_state(model: Model, opt_cfg: adamw.AdamWConfig, seed: int, mesh=None):
    """(params, opt_state): the model drawn from a generator seeded with
    ``seed`` on the model's device, and a zero optimizer state; on a
    ``mesh`` both placed by ``params_sharding`` and ``opt_state_sharding``
    (each rank draws the same whole tree and keeps its shards)."""
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    opt_state = adamw.init_state(opt_cfg, params)
    if mesh is not None:
        return place_state(params, opt_state, mesh)
    return params, opt_state


def place_state(params, opt_state, mesh):
    """Whole (params, opt_state) as DTensors on ``mesh`` by the rules."""
    o_sh = sh.opt_state_sharding(opt_state, params, mesh)
    return (sh.distribute(params, sh.params_sharding(params, mesh), mesh),
            sh.distribute(opt_state, o_sh, mesh))


def train(cfg, opts: TrainOptions, injector: Optional[FailureInjector] = None,
          monitor: Optional[StragglerMonitor] = None) -> Dict[str, Any]:
    """Train ``opts.steps`` steps (resuming from ``opts.ckpt_dir``'s latest
    checkpoint, where there is one). Returns {params, opt_state, history
    [(step, loss, seconds)], final_step}."""
    model = Model(cfg, device=resolve_device(opts.device))
    opt_cfg = adamw.AdamWConfig(lr=opts.lr, state_dtype=opts.state_dtype)
    mesh = None
    if opts.mesh_shape:
        mesh = mesh_mod.make_mesh(opts.mesh_shape, ("data", "model"),
                                  device=model.device.type)
        pctx.install(("data",), tp_size=mesh_mod.axis_size(mesh, "model"),
                     sp_seq=False, mesh=mesh)
    try:
        return _train(cfg, opts, model, opt_cfg, mesh, injector, monitor)
    finally:
        if mesh is not None:
            pctx.clear()


def _train(cfg, opts, model, opt_cfg, mesh, injector, monitor):
    params, opt_state = build_state(model, opt_cfg, opts.seed, mesh)
    p_sh = sh.params_sharding(params, mesh) if mesh is not None else None
    step_fn = steps_mod.make_train_step(model, opt_cfg, accum_steps=opts.accum_steps,
                                        grad_compression=opts.grad_compression,
                                        grad_shardings=p_sh)

    start_step = 0
    ckpt = None
    if opts.ckpt_dir:
        ckpt = store.AsyncCheckpointer(opts.ckpt_dir, keep=opts.keep)
        latest = store.latest_step(opts.ckpt_dir)
        if latest is not None:
            if mesh is not None:  # restored whole, each rank keeps its shards
                (params, opt_state), _ = elastic.restore_on_mesh(
                    opts.ckpt_dir, (params, opt_state), mesh, kind="state", step=latest)
            else:
                (params, opt_state), _ = store.restore(opts.ckpt_dir, (params, opt_state),
                                                       step=latest)
            start_step = latest
            print(f"[train] resumed from step {start_step}")

    source = SyntheticTokens(SyntheticConfig(cfg.vocab, opts.seq, opts.batch, seed=opts.seed))
    loader = PrefetchLoader(source, start_step=start_step)
    monitor = monitor or StragglerMonitor()
    hb = Heartbeat(os.path.join(opts.ckpt_dir, "HEARTBEAT")) if opts.ckpt_dir else None

    history = []
    step = start_step
    try:
        while step < opts.steps:
            t0 = time.perf_counter()
            _, np_batch = loader.get(step)
            if injector:
                injector.maybe_fail(step, "step")
            params, opt_state, metrics = step_fn(params, opt_state, np_batch)
            loss = float(metrics["loss"])  # waits for the step's work
            dt = time.perf_counter() - t0
            ev = monitor.record(step, dt, loader.fetch_seconds.get(step, 0.0))
            if ev:
                print(f"[straggler] step {step}: {ev.mitigation} "
                      f"({ev.step_seconds:.2f}s vs median {ev.median_seconds:.2f}s)")
            if hb:
                hb.beat(step)
            step += 1
            if step % opts.log_every == 0 or step == opts.steps:
                history.append((step, loss, dt))
                print(f"[train] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if ckpt and (step % opts.ckpt_every == 0 or step == opts.steps):
                if injector:
                    injector.maybe_fail(step, "save")
                ckpt.save(step, (params, opt_state), meta={"loss": loss})
    finally:
        loader.close()
        if ckpt:
            ckpt.wait()
    return {"params": params, "opt_state": opt_state, "history": history,
            "final_step": step}


def train_with_recovery(cfg, opts: TrainOptions,
                        injector: Optional[FailureInjector] = None,
                        policy: Optional[RestartPolicy] = None) -> Dict[str, Any]:
    """Outer supervision loop: on failure, restart from the latest checkpoint."""
    policy = policy or RestartPolicy()
    while True:
        try:
            return train(cfg, opts, injector=injector)
        except InjectedFailure as e:
            print(f"[recovery] {e}; restarting "
                  f"({policy.restarts + 1}/{policy.max_restarts})")
            if not policy.should_restart(e):
                raise


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4: a ('data', 'model') device mesh (one rank on "
                         "this host unless a launcher such as torchrun set "
                         "WORLD_SIZE)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--schedule-db", default=None,
                    help="warm schedule DB (JSONL); the kernels' block picks "
                         "become lookups")
    args = ap.parse_args(argv)

    if args.schedule_db:
        from repro_torch.kernels.ops import use_schedule_db

        use_schedule_db(args.schedule_db)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opts = TrainOptions(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        accum_steps=args.accum, lr=args.lr,
        grad_compression=args.grad_compression,
        mesh_shape=tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None,
        device=args.device,
    )
    started = bool(opts.mesh_shape) and not torch.distributed.is_initialized()
    if opts.mesh_shape:
        mesh_mod.init_process_group(args.device)
    try:
        out = train_with_recovery(cfg, opts)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    last = out["history"][-1][1] if out["history"] else float("nan")
    print(f"done at step {out['final_step']}; last loss {last:.4f}")


if __name__ == "__main__":
    main()

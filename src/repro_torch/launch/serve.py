"""Batched serving entry point: continuous batching (default) or wave fallback.

* ``continuous`` (default) — ``launch/engine.py``: per-slot position
  vectors, an admission queue with per-request deadlines, and slot refill
  the moment a request finishes (EOS / ``max_new`` / deadline).
* ``wave`` (fallback, for parity comparison) — waves of ``slots`` equal-
  length prompts prefill batched, then decode in lockstep with a scalar
  position; a finished request parks its slot until the wave drains.

Both report per-request TTFT / end-to-end latency percentiles and
``wasted_slot_steps`` (slot-steps burned on pad/finished slots).

On the card:  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
On the CPU:   PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
    --reduced --device cpu --requests 6 --slots 2 --max-new 16

It serves the token-only archs (all but whisper-large-v3 and internvl2-1b,
whose prefill needs stub frames or patches and which, as in the reference,
run through ``Model.prefill`` and ``Model.decode_step`` only).

``--schedule-cache F`` serves the kernel block picks from a snapshot
(``python -m repro_torch.tuna snapshot``), polled for republishes at
admission or wave boundaries; ``--schedule-db F`` from a warm DB.
``--kernel-bundle B`` installs a golden kernel bundle (``python -m
repro_torch.tuna golden --bundle``) before the model's first launch: the
kernels run from the libraries it carries, so a cold start runs no nvcc,
and its schedule index is the pickers' first tier.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import tuner
from repro_torch.kernels import ops
from repro_torch.launch.engine import ContinuousEngine, Request, request_stats
from repro_torch.models.model import Model

__all__ = ["Request", "ServeEngine", "serve", "group_into_waves"]


def group_into_waves(requests: List[Request], slots: int) -> List[List[Request]]:
    """Bucket by prompt length (wave prefill is one batched call, so a wave
    must be homogeneous), then chunk each bucket into waves of at most
    ``slots``. Submission order is preserved within a bucket."""
    buckets: Dict[int, List[Request]] = {}
    for r in requests:
        buckets.setdefault(len(r.prompt), []).append(r)
    waves = []
    for length in buckets:
        group = buckets[length]
        waves.extend(group[i: i + slots] for i in range(0, len(group), slots))
    return waves


class ServeEngine:
    """Lockstep wave scheduler (the fallback baseline)."""

    def __init__(self, model: Model, params, slots: int, cap: int):
        self.model = model
        self.params = params
        self.slots = slots
        self.cap = cap
        self.engine_steps = 0        # decode steps
        self.slot_steps = 0          # slot-steps doing live work
        self.wasted_slot_steps = 0   # slot-steps on pad/finished slots
        self.prefills = 0
        self._t0 = time.perf_counter()

    def run_wave(self, wave: List[Request]) -> None:
        if len({len(r.prompt) for r in wave}) != 1:
            raise ValueError("a wave holds prompts of one length")
        n = len(wave)
        prompts = np.array([r.prompt for r in wave], np.int32)
        if n < self.slots:  # pad to engine width
            prompts = np.pad(prompts, ((0, self.slots - n), (0, 0)))
        batch = {"tokens": torch.from_numpy(prompts).to(self.model.device)}
        cache, pos, last_logits = self.model.prefill(self.params, batch, self.cap)
        self.prefills += 1
        tok = torch.argmax(last_logits[:, 0], dim=-1).to(torch.int32)
        tok_np = tok.cpu().numpy()  # one host sync per step, not one per slot
        now = time.perf_counter() - self._t0
        for i, r in enumerate(wave):
            r.out.append(int(tok_np[i]))
            r.t_first = now
            if len(r.out) >= r.max_new:
                r.t_done = now
        max_new = max(r.max_new for r in wave)
        for t in range(max_new - 1):
            # pad rows and already-finished requests still run the full
            # decode step — the wave scheduler's cost, reported as waste
            live = sum(1 for r in wave if len(r.out) < r.max_new)
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   pos + t)
            self.engine_steps += 1
            self.slot_steps += live
            self.wasted_slot_steps += self.slots - live
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            tok_np = tok.cpu().numpy()
            now = time.perf_counter() - self._t0
            for i, r in enumerate(wave):
                if len(r.out) < r.max_new:
                    r.out.append(int(tok_np[i]))
                    if len(r.out) >= r.max_new:
                        r.t_done = now


def serve(model: Model, params, requests: List[Request], slots: int,
          cap: int, refresh=None, scheduler: str = "continuous") -> Dict:
    """Serve ``requests`` with the chosen scheduler.

    ``refresh`` (nullary, returns True on change) is the schedule-snapshot
    hot-reload hook: a republish lands in a long-running serve process with
    no restart. The wave scheduler polls it *between* waves (never
    mid-wave); the continuous engine polls at *admission* boundaries."""
    t0 = time.perf_counter()
    if scheduler == "continuous":
        engine = ContinuousEngine(model, params, slots, cap, refresh=refresh)
        engine.run(requests)
        stats = engine.stats()
    elif scheduler == "wave":
        engine = ServeEngine(model, params, slots, cap)
        reloads = 0
        for i, wave in enumerate(group_into_waves(requests, slots)):
            if refresh is not None and i and refresh():
                reloads += 1
            engine.run_wave(wave)
        stats = {"engine_steps": engine.engine_steps,
                 "slot_steps": engine.slot_steps,
                 "wasted_slot_steps": engine.wasted_slot_steps,
                 "prefills": engine.prefills,
                 "cache_reloads": reloads}
    else:
        raise ValueError(f"unknown scheduler: {scheduler!r}")
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in requests)
    stats.update({"scheduler": scheduler, "wall_s": wall, "tokens": toks,
                  "tok_per_s": toks / max(wall, 1e-9)})
    stats.update(request_stats(requests))
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--scheduler", choices=("continuous", "wave"),
                    default="continuous",
                    help="continuous = per-slot positions + refill on free; "
                         "wave = lockstep fallback for parity comparison")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--schedule-db", default=None,
                    help="warm schedule DB (JSONL) so the kernel block picks "
                         "are lookups, not searches")
    ap.add_argument("--schedule-cache", default=None,
                    help="immutable schedule snapshot (python -m "
                         "repro_torch.tuna snapshot), consulted before the "
                         "DB. Accepts a versioned snapshot or a "
                         "SnapshotManager `latest` pointer; polled at "
                         "admission/wave boundaries, so a republish lands "
                         "without restart")
    ap.add_argument("--no-schedule-refresh", action="store_true",
                    help="do not poll the snapshot while serving (pin the "
                         "instance loaded at startup)")
    ap.add_argument("--kernel-bundle", default=None,
                    help="golden kernel bundle (python -m repro_torch.tuna "
                         "golden --bundle, or its `latest` pointer), loaded "
                         "for --device: the first schedule-lookup tier, and "
                         "on the card the compiled kernel libraries, so a "
                         "cold start runs nvcc zero times")
    args = ap.parse_args(argv)

    if args.schedule_db:
        ops.use_schedule_db(args.schedule_db)
    if args.schedule_cache:
        ops.use_schedule_cache(args.schedule_cache)
    if args.kernel_bundle:
        ops.use_kernel_bundle(args.kernel_bundle, device=args.device)
        print(f"[serve] kernel bundle: {ops.get_kernel_bundle().describe()}")

    cfg = get_config(args.arch)
    if cfg.frontend:
        ap.error(f"{args.arch} needs {cfg.frontend} inputs besides tokens; it runs "
                 f"through Model.prefill and Model.decode_step, not this serve")
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len)],
                    args.max_new)
            for i in range(args.requests)]
    cap = args.prompt_len + args.max_new + 2
    # --schedule-cache or $REPRO_TUNA_CACHE both install a snapshot; either
    # way the serve loop polls for republishes (a stale or unbuilt env
    # snapshot resolves to OFF at startup and heals through the poll)
    cache_installed = bool(args.schedule_cache
                           or os.environ.get("REPRO_TUNA_CACHE"))
    refresh = None
    if cache_installed and not args.no_schedule_refresh:
        def refresh():
            swapped = ops.refresh_schedule_cache()
            if swapped:
                print("[serve] schedule snapshot republish observed — "
                      "hot-reloaded (hit counters reset)")
            return swapped

    stats = serve(model, params, reqs, slots=args.slots, cap=cap,
                  refresh=refresh, scheduler=args.scheduler)
    print(f"[serve] {stats['scheduler']}: {stats['tokens']} tokens in "
          f"{stats['wall_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s, "
          f"{stats['engine_steps']} engine steps, "
          f"{stats['slot_steps']} live slot-steps, "
          f"{stats['wasted_slot_steps']} wasted)")
    print(f"[serve] ttft p50/p95/p99 = {stats['ttft_s']['p50']:.3f}/"
          f"{stats['ttft_s']['p95']:.3f}/{stats['ttft_s']['p99']:.3f}s; "
          f"latency p50/p95/p99 = {stats['latency_s']['p50']:.3f}/"
          f"{stats['latency_s']['p95']:.3f}/{stats['latency_s']['p99']:.3f}s")

    if cache_installed:
        cache = tuner.get_default_cache()
        if cache is None:
            print("[serve] schedule cache: none installed (snapshot "
                  "missing or stale; republish to hot-load it)")
        else:
            print(f"[serve] schedule cache: {cache.hits} hits / "
                  f"{cache.misses} misses ({len(cache)} records, "
                  f"{stats['cache_reloads']} hot reloads)")
    if args.kernel_bundle:
        bundle = ops.get_kernel_bundle()
        print(f"[serve] kernel bundle: {bundle.hits} schedule hits / "
              f"{bundle.misses} misses, {bundle.exec_hits} bundled kernel "
              f"hits / {bundle.exec_misses} misses; nvcc runs this process: "
              f"{ops.kernel_build_counts()}; launches: {ops.launch_counts()}")


if __name__ == "__main__":
    main()

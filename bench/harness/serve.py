"""A serve cell: closed-loop clients against the port's continuous engine.

Set-up draws the weights and the requests from the seed and serves a short
warm-up list that holds the run's longest prompt (the caching allocator
then holds the window's largest buffers, the kernels are loaded and each
prompt length's flash blocks are picked). The window is one call to
``repro_torch.launch.serve.serve(..., scheduler="continuous")`` over the
whole list, ramp and drain included.

With ``trace`` the harness wraps the model's ``prefill`` and
``decode_step`` in ranges of its own (``bench.prefill``,
``bench.decode_step``) and profiles two stretches of the window (the
device's, then with the host's ranges; ``trace.Stretches``), ``TRACE_S``
seconds each, opened at the first decode step, from the ``TRACE_FROM``-th
on, that follows a client's second admission.

Correctness: after the window, with the engine freed and the peak memory
read, a sample of the finished requests drawn from the seed (the longest
among them) runs through the plain reference over its prompt and its served
tokens; the widest gap by which a served token's logit lies below the
reference's best (or, where the mix says so, the mean gap over the
sampled tokens) is held to the mix's limit.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from harness import traffic, weights

TRACE_FROM = 8        # decode steps before the traced stretches open
TRACE_S = 2.0         # seconds each traced stretch lasts


class _Recorder:
    """The harness's own ranges around the model's two entry points, the
    traced stretches opened and closed at decode steps, and what each traced
    call did (prompt lengths; the live slots' positions)."""

    def __init__(self, model, stretches, clients: int):
        self.model = model
        self.stretches = stretches
        self.clients = clients
        self.n_decode = self.n_prefill = 0
        self._prefill, self._decode = model.prefill, model.decode_step
        model.prefill, model.decode_step = self.prefill, self.decode_step

    def restore(self):
        self.model.prefill, self.model.decode_step = self._prefill, self._decode

    def prefill(self, params, batch, cap):
        self.n_prefill += 1
        self.stretches.record("prefills", int(batch["tokens"].shape[1]))
        with torch.profiler.record_function("bench.prefill"):
            return self._prefill(params, batch, cap)

    def decode_step(self, params, cache, token, pos):
        self.n_decode += 1
        # open once the loop runs: past the opening admissions and at least
        # one client's next request, so that the stretches hold prefills
        self.stretches.step(self.n_decode >= TRACE_FROM and self.n_prefill > self.clients,
                            seconds=TRACE_S)
        self.stretches.record("decodes", [int(p) for p in pos.tolist() if p > 0])
        with torch.profiler.record_function("bench.decode_step"):
            return self._decode(params, cache, token, pos)


def _requests(specs):
    from repro_torch.launch.engine import Request

    return [Request(i, list(s.prompt), s.max_new) for i, s in enumerate(specs)]


def run(cell) -> Dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    c, mix, dev = cell.config, cell.workload["traffic"], cell.device
    model = Model(cell.arch, device=dev)
    params, flat = weights.make(weights.shapes(model), cell.seed, dev)
    cell.sync()
    cell.note(f"set-up: weights drawn at {time.perf_counter() - cell.t_start:.2f} s")
    specs = traffic.requests(mix, cell.seed, cell.seconds, c["vocab_size"])
    slots, cap = mix["clients"], mix["cap"]
    for s in sorted({len(r.prompt) for r in specs}):
        ops.tuned_flash_blocks(s, cell.arch.head_dim, cell.arch.torch_compute_dtype().itemsize)
    longest = max(specs, key=lambda r: len(r.prompt))
    warm = [traffic.Spec(longest.prompt, 3)] + [traffic.Spec(r.prompt, 3) for r in specs[:3]]
    t_warm = time.perf_counter()
    serve(model, params, _requests(warm), slots=slots, cap=cap, scheduler="continuous")
    cell.note(f"set-up: warm-up serve {time.perf_counter() - t_warm:.2f} s")
    before = weights.checksum(flat)
    cell.sync()

    reqs = _requests(specs)
    stretches = cell.stretches()
    rec = _Recorder(model, stretches, slots) if cell.trace else None
    cell.window_open()
    t0 = time.perf_counter()
    stats = serve(model, params, reqs, slots=slots, cap=cap, scheduler="continuous")
    wall = time.perf_counter() - t0
    cell.window_closed()
    if rec is not None:
        stretches.close()
        rec.restore()
    del stats["requests"]
    tokens = sum(len(r.out) for r in reqs)
    failed = sum(1 for r in reqs if r.t_done is None or len(r.out) < r.max_new)
    t_first = [r.t_first for r in reqs]
    t_done = [r.t_done for r in reqs]
    ttft = traffic.closed_loop_ttft(t_first, t_done, slots)
    cell.note(f"window {wall:.3f} s: {len(reqs)} requests, {tokens} tokens, "
              f"opening TTFTs p50/max {np.median(t_first[:slots]):.4f}/"
              f"{max(t_first[:slots]):.4f} s, closed-loop TTFT p50 "
              f"{np.median(ttft):.4f} s over {len(ttft)}; engine {stats}")
    metrics = {"output_tokens_per_s": (tokens / wall, "tokens/s"),
               "ttft_p95_s": (traffic.p95(ttft), "s")}
    peak = cell.memory_peak()
    counters = {"engine": {k: stats[k] for k in (
        "engine_steps", "slot_steps", "wasted_slot_steps", "prefills")}}
    reading = stretches.reading()
    if reading.get("trace") is not None:
        flash = reading["trace"].kernel_count(lambda n: "flash_fwd" in n)
        cell.note(f"traced: {len(reading['calls'].get('prefills', []))} prefills, "
                  f"{len(reading['calls'].get('decodes', []))} decode steps, {flash} flash "
                  f"launches, {len(reading['trace'].kernels)} device operations")
    checks = check(cell, params, flat, before, reqs)
    return {"attempted": len(reqs), "failed": failed, "metrics": metrics,
            "memory_peak_bytes": peak, "reading": reading, "checks": checks,
            "counters": counters}


def check(cell, params, flat, before: float, reqs) -> Dict:
    """The numbers that decide ``correct``, each with its limit."""
    from reference import decoder

    limits = cell.workload["check"]
    sample = sample_requests(reqs, limits["served_tokens"], limits.get("min_requests", 1),
                             cell.seed)
    seqs = [(r.prompt, r.out) for r in sample]
    t0 = time.perf_counter()
    logits = decoder.served_logits(cell.config, params, seqs)
    g = torch.cat([decoder.gaps(lg, r.out) for lg, r in zip(logits, sample)])
    cell.note(f"reference over {len(sample)} requests, {g.numel()} served tokens, "
              f"{time.perf_counter() - t0:.1f} s; gaps {describe(g)}, "
              f"{int((g > 0).sum())} tokens not the reference's best")
    if cell.overrides.get("control"):
        low = decoder.served_logits(cell.config, params, seqs, precision="fp8")
        cg = torch.cat([decoder.gaps(lg, lo.argmax(-1).tolist()) for lg, lo in zip(logits, low)])
        cell.control = gap_statistic(cg, limits)
        cell.note(f"control (fp8 products): gaps {describe(cg)}")
    unfinished = sum(1 for r in reqs if r.t_done is None or len(r.out) < r.max_new)
    return {gap_name(limits): (gap_statistic(g, limits), limits["gap_limit"]),
            "unfinished": (unfinished, 0),
            "weights_moved": (abs(weights.checksum(flat) - before), 0)}


def describe(g: torch.Tensor) -> str:
    return (f"mean/p50/p90/p95/max {float(g.mean()):.4f}/{float(g.median()):.4f}/"
            f"{float(g.quantile(0.9)):.4f}/{float(g.quantile(0.95)):.4f}/{float(g.max()):.4f}")


def gap_name(limits: Dict) -> str:
    return "served_gap_mean" if limits.get("gap") == "mean" else "served_gap"


def gap_statistic(g: torch.Tensor, limits: Dict) -> float:
    """The widest gap, or where the mix says ``"gap": "mean"`` the mean
    gap over the sampled tokens."""
    return float(g.mean()) if limits.get("gap") == "mean" else float(g.max())


def sample_requests(reqs, served_tokens: int, min_requests: int, seed: int):
    """The request with the longest sequence, then others drawn from the
    seed, until they hold ``served_tokens`` served tokens and number
    ``min_requests`` or more."""
    done = [r for r in reqs if r.t_done is not None and r.out]
    rng = np.random.default_rng([seed, 1])
    longest = max(done, key=lambda r: len(r.prompt) + len(r.out))
    order = [r for r in (done[i] for i in rng.permutation(len(done))) if r is not longest]
    out, n = [longest], len(longest.out)
    for r in order:
        if n >= served_tokens and len(out) >= min_requests:
            break
        out.append(r)
        n += len(r.out)
    return out

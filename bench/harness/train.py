"""A train cell: the port's training step, driven by batches from the seed.

Set-up builds one step (``launch.steps.make_train_step``, the model and its
AdamW state, the parameters the benchmark drew) and drives it through its
first ``check.steps`` steps on batches of the window's own feed (rows that
all differ); that same step and state then run the window, a step after a
step until ``seconds`` have passed. ``train_tokens_per_s`` is the window's
tokens over the window. The step's learning rate is the mix's, held
constant (the fine-tune past its warm-up).

Correctness: the reference follows the set-up's steps from the same
weights and batches. Compared are each step's loss, each leaf's first
gradient as the optimizer got it (its first moment after step 1, over
1 - b1) and each leaf's change after the last set-up step (read before the
window moves it), each leaf a stacked leaf's layer; by the worst leaf, the
gap of the norms against the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is under
a thousandth of the median leaf's are left out of the change.

The peak memory is reset when the window opens: set-up holds a second copy
of the initial weights for the change, which the program never holds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import weights

TRACE_FROM = 1        # window steps before the traced stretches open
TRACE_STEPS = 2       # steps in each traced stretch
EXCLUDE_BELOW = 1e-3  # a leaf's gradient under this share of the median's: not compared


def _constant(step):
    return 1.0


class Feed:
    """Batches [B, S] of token ids drawn from the seed on the device, the
    labels each row's next tokens."""

    def __init__(self, seed: int, rows: int, tokens: int, vocab: int, device):
        sub = int(np.random.default_rng([seed, 3]).integers(2**62))
        self.gen = torch.Generator(device=device).manual_seed(sub)
        self.shape, self.vocab, self.device = (rows, tokens + 1), vocab, device

    def next(self) -> Dict[str, torch.Tensor]:
        t = torch.randint(0, self.vocab, self.shape, generator=self.gen, device=self.device,
                          dtype=torch.int32)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def leaf_views(tree) -> Dict[Tuple[str, int], torch.Tensor]:
    """Each leaf of the port's tree by (name, layer): a stacked leaf's
    layer ``i`` as ("mixer.wq", i), a leaf outside the stack at -1."""
    out = {}
    for path, t in weights.leaves(tree):
        if path[0] == "layers":
            name = ".".join(str(k) for k in path[2:])
            for i in range(t.shape[0]):
                out[(name, i)] = t[i]
        else:
            out[(".".join(str(k) for k in path), -1)] = t
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def run(cell) -> Dict:
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    wl, dev = cell.workload, cell.device
    rows, seq = wl["batch"]["rows"], wl["batch"]["tokens"]
    o = wl["optimizer"]
    model = Model(dataclasses.replace(cell.arch, remat_stack=wl["remat"]), device=dev)
    abstract = weights.shapes(model)
    params, flat = weights.make(abstract, cell.seed, dev)
    opt_cfg = adamw.AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                                weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                                state_dtype=o["state_dtype"])
    opt_state = adamw.init_state(opt_cfg, params)
    step = steps.make_train_step(model, opt_cfg, schedule=_constant)
    feed = Feed(cell.seed, rows, seq, cell.config["vocab_size"], dev)

    batches, losses = [], []
    for k in range(wl["check"]["steps"]):
        batches.append(feed.next())
        params, opt_state, m = step(params, opt_state, batches[-1])
        losses.append(float(m["loss"]))
        if k == 0:
            grad = {key: _norm(v) / (1 - o["b1"])
                    for key, v in leaf_views(opt_state["m"]).items()}
    before = leaf_views(weights.make(abstract, cell.seed, dev)[0])
    change = {key: _norm(v.float() - before[key].float())
              for key, v in leaf_views(params).items()}
    del before
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    stretches = cell.stretches()
    cell.window_open()
    t0 = time.perf_counter()
    n = 0
    while True:
        stretches.step(n >= TRACE_FROM, units=TRACE_STEPS)
        stretches.record("steps", 1)
        with torch.profiler.record_function("bench.step"):
            params, opt_state, m = step(params, opt_state, feed.next())
            float(m["loss"])  # the step's work is done
        n += 1
        if time.perf_counter() - t0 >= cell.seconds and not stretches.open() \
                and n > TRACE_FROM:
            break
    cell.window_closed()
    stretches.close()
    wall = cell.t_closed - t0
    peak = cell.memory_peak()
    cell.note(f"window {wall:.3f} s: {n} steps of {rows} x {seq} tokens; set-up losses {losses}")
    out = {"attempted": n, "failed": 0,
           "metrics": {"train_tokens_per_s": (n * rows * seq / wall, "tokens/s")},
           "memory_peak_bytes": peak}
    if cell.trace:
        out["reading"] = stretches.reading()
        for calls in (out["reading"]["calls"], out["reading"]["span_calls"]):
            calls.update(rows=rows, tokens=seq)
    del params, opt_state, flat, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(cell, abstract, batches, losses, grad, change)
    return out


def worst_gap(got: Dict, want: Dict, keys: List) -> Tuple[float, object]:
    """The largest |got - want| over max(want, the median of want), and its key."""
    med = float(np.median([want[k] for k in want]))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def reference_run(cell, abstract, batches, precision: str):
    """The reference's (losses, first gradient norms, change norms) over
    ``batches`` from the benchmark's initial weights."""
    from reference import train as ref

    c, o = cell.config, cell.workload["optimizer"]
    p0_tree, _ = weights.make(abstract, cell.seed, cell.device)
    p0 = leaf_views(p0_tree)
    opt = ref.AdamW(o["lr"], o["b1"], o["b2"], o["eps"], o["weight_decay"], o["grad_clip"],
                    getattr(torch, o["state_dtype"]))
    clipped = []   # each step's clipped gradients, by (name, i)

    def weights_at(k):
        """Leaf (name, i) after ``k`` steps, worked out from p0 and the
        clipped gradients of the steps before."""
        def w(name, i):
            p, m, v = p0[(name, i)].to(torch.float32, copy=True), None, None
            for t in range(k):
                p, m, v = opt.update(p, clipped[t][(name, i)], m, v, t + 1)
            return p
        return w

    def sumsq(t):
        return float(t.double().square().sum())

    # every step but the last keeps its clipped gradients (the next steps'
    # weights are worked out from them); the last runs twice, first for its
    # clip's norm, then for each leaf's change as its gradient is made
    losses = []
    for k, batch in enumerate(batches[:-1]):
        loss, g = ref.loss_and_grads(c, weights_at(k), batch, precision)
        clip = opt.clip_factor(sum(sumsq(t) for t in g.values()))
        for t in g.values():
            t.mul_(clip)
        clipped.append(g)
        losses.append(loss)
    k = len(batches) - 1
    total = [0.0]
    loss, _ = ref.loss_and_grads(c, weights_at(k), batches[k], precision,
                                 on_grad=lambda key, g: total.__setitem__(0, total[0] + sumsq(g)))
    losses.append(loss)
    clip = opt.clip_factor(total[0])
    change = {}

    def leaf_change(key, g):
        p, m, v = p0[key].float(), None, None
        for t in range(k):
            p, m, v = opt.update(p, clipped[t][key], m, v, t + 1)
        p, _, _ = opt.update(p, g * clip, m, v, k + 1)
        change[key] = _norm(p - p0[key].float())

    ref.loss_and_grads(c, weights_at(k), batches[k], precision, on_grad=leaf_change)
    grad = {key: _norm(t) for key, t in clipped[0].items()} if clipped else None
    return losses, grad, change


def gaps(losses, grad, change, truth) -> Dict:
    """The three numbers of one run against the reference's ``truth``."""
    t_losses, t_grad, t_change = truth
    med = float(np.median(list(t_grad.values())))
    moved = [k for k in t_change if t_grad[k] >= EXCLUDE_BELOW * med]
    g, g_at = worst_gap(grad, t_grad, list(t_grad))
    ch, ch_at = worst_gap(change, t_change, moved)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, t_losses)),
            "grad_gap": g, "grad_at": g_at, "change_gap": ch, "change_at": ch_at,
            "left_out": len(t_change) - len(moved)}


def check(cell, abstract, batches, losses, grad, change) -> Dict:
    lim = cell.workload["check"]
    t0 = time.perf_counter()
    truth = reference_run(cell, abstract, batches, "f32")
    got = gaps(losses, grad, change, truth)
    cell.note(f"reference over {len(batches)} steps in {time.perf_counter() - t0:.1f} s: "
              f"losses {truth[0]} (program {losses}); {got}; worst grad leaf: program "
              f"{grad[got['grad_at']]:.6e}, reference {truth[1][got['grad_at']]:.6e}; worst "
              f"change leaf: program {change[got['change_at']]:.6e}, reference "
              f"{truth[2][got['change_at']]:.6e}")
    if cell.overrides.get("control"):
        cell.control = gaps(*reference_run(cell, abstract, batches, "fp8"), truth)
        cell.note(f"control (fp8 products): {cell.control}")
    return {name: (got[name], lim[name.replace("_gap", "_limit")])
            for name in ("loss_gap", "grad_gap", "change_gap")}

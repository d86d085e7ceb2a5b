"""An ops cell: passes of a model's products through ``ops.matmul``.

A pass runs the products the mix names (each weight of a layer, at each
row count) for every layer of the configuration, each layer with weights
and activations of its own, so that the weights are read from the card's
memory as a served forward reads them and not from its L2 cache: the
products of one whole forward at each row count. It passes no ``blocks``:
every pick is the static tuner's, made once in set-up with no schedule
store installed. The window runs whole passes until ``seconds`` have passed
on the host clock, then waits for the device; ``tuned_gemm_ms`` is the
window over the passes.

Correctness: the outputs of the last pass and of one pass drawn from the
seed are compared, product by product, with the plain reference on the same
operands (the largest element error over the largest reference element).

With ``trace`` two stretches of passes are profiled (``trace.Stretches``;
each pass in a ``bench.pass`` range) and every configuration of each
distinct shape's ``sm90`` space is timed by CUDA-graph replay
(``timer.py``) over that shape's products in every layer, for the tuner's
measured-best over its pick.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

TRACE_FROM = 5        # passes before the traced stretches open
TRACE_S = 2.0         # seconds each traced stretch lasts
SAMPLE_BELOW = 20     # the sampled pass is one of the first this many
CHUNK = 2**30         # one normal_ call fills at most this many elements


def widths(c: Dict) -> Dict[str, int]:
    from harness.config import head_dim

    dh = head_dim(c)
    return {"hidden_size": c["hidden_size"], "intermediate_size": c["intermediate_size"],
            "q_width": c["num_attention_heads"] * dh, "kv_width": c["num_key_value_heads"] * dh}


def operands(cell) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(label, A [M, K], B [K, N]) of each product of a pass, drawn from
    the seed on the device in the mix's dtype into one buffer, filled by a
    ``torch.Generator`` in a few large calls: B like a weight (scaled by
    K^-1/2), A like normed activations; each layer its own weights and one
    A per (layer, M, K)."""
    prods = cell.workload["products"]
    dtype = getattr(torch, prods["dtype"])
    w = widths(cell.config)
    layers = cell.config["num_hidden_layers"]
    mats = [(name, w[k], w[n]) for name, (k, n) in prods["weights"].items()]
    acts = sorted({(m, k) for m in prods["rows"] for _, k, _ in mats})
    total = layers * (sum(k * n for _, k, n in mats) + sum(m * k for m, k in acts))
    flat = torch.empty(total, dtype=dtype, device=cell.device)
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    for c0 in range(0, total, CHUNK):
        flat[c0:c0 + CHUNK].normal_(generator=gen)
    at = 0

    def take(rows, cols, scale):
        nonlocal at
        view = flat[at:at + rows * cols].view(rows, cols)
        at += rows * cols
        return view.mul_(scale) if scale != 1.0 else view

    weights = [{name: take(k, n, k ** -0.5) for name, k, n in mats} for _ in range(layers)]
    a = [{mk: take(*mk, 1.0) for mk in acts} for _ in range(layers)]
    out = []
    for m in prods["rows"]:
        for layer in range(layers):
            for name, b in weights[layer].items():
                out.append((f"{name}.{layer}@{m}", a[layer][(m, b.shape[0])], b))
    return out


def run(cell) -> Dict:
    from harness import timer
    from repro_torch.kernels import ops

    prods = operands(cell)
    shapes = [(a.shape[0], b.shape[1], a.shape[1]) for _, a, b in prods]

    def one_pass():
        return [ops.matmul(a, b) for _, a, b in prods]

    for _ in range(3):
        one_pass()
    cell.sync()
    picks = {s: ops.tuned_matmul_blocks(*s, 2) for s in sorted(set(shapes))}
    sampled = int(np.random.default_rng([cell.seed, 2]).integers(SAMPLE_BELOW))

    stretches = cell.stretches()
    kept = None
    cell.window_open()
    t0 = time.perf_counter()
    passes = 0
    while True:
        stretches.step(passes >= TRACE_FROM, seconds=TRACE_S)
        stretches.record("passes", 1)
        with torch.profiler.record_function("bench.pass"):
            outs = one_pass()
        if passes == sampled:
            kept = outs
        passes += 1
        if time.perf_counter() - t0 >= cell.seconds and passes > SAMPLE_BELOW \
                and not stretches.open():
            break
    cell.window_closed()
    wall = cell.t_closed - t0
    stretches.close()
    peak = cell.memory_peak()
    cell.note(f"window {wall:.3f} s: {passes} passes of {len(prods)} products; picks {picks}")
    out = {"attempted": passes * len(prods), "failed": 0,
           "metrics": {"tuned_gemm_ms": (1e3 * wall / passes, "ms")},
           "memory_peak_bytes": peak,
           "checks": check(cell, prods, [kept, outs])}
    if cell.trace:
        out["reading"] = stretches.reading()
        out["reading"]["calls"]["shapes"] = shapes
        if cell.device.type == "cuda":  # graph replay times a card only
            out["extra"] = {"oracle": oracle(cell, prods, picks, timer)}
    return out


def check(cell, prods, passes) -> Dict:
    from reference.matmul import product, rel_err

    worst, control = 0.0, 0.0
    for i, (label, a, b) in enumerate(prods):
        want = product(a, b)
        for outs in passes:
            worst = max(worst, rel_err(outs[i], want))
        if cell.overrides.get("control"):
            control = max(control, rel_err(product(a, b, "fp8"), want))
    if cell.overrides.get("control"):
        cell.control = control
        cell.note(f"control (fp8 operands): rel_err {control:.6f}")
    return {"rel_err": (worst, cell.workload["check"]["rel_err_limit"])}


def oracle(cell, prods, picks, timer) -> Dict:
    """Every configuration of each distinct shape's ``sm90`` space timed by
    graph replay over that shape's products (one per layer, as a pass runs
    them): {shape: (pick seconds, best seconds)}, each a product's."""
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.kernels import matmul as kmatmul

    by_shape: Dict[tuple, list] = {}
    for _, a, b in prods:
        by_shape.setdefault((a.shape[0], b.shape[1], a.shape[1]), []).append((a, b))
    out = {}
    for shape, pairs in by_shape.items():
        times = {}
        for cfg in MatmulSpace(*shape, 2, target_kind="sm90").enumerate(None):
            key = (cfg["bm"], cfg["bn"], cfg["bk"], cfg["double_buffer"])
            times[key] = timer.replay_seconds(
                lambda: [kmatmul.matmul(a, b, bm=key[0], bn=key[1], bk=key[2],
                                        double_buffer=key[3]) for a, b in pairs],
                cell.device, iters=1) / len(pairs)
        pick = tuple(picks[shape])
        if pick not in times:
            raise KeyError(f"the pick {pick} at {shape} is not in its space")
        out[shape] = (times[pick], min(times.values()))
    return out

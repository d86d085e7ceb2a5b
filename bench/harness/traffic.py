"""Closed-loop serve traffic from a mix file and a seed.

A mix gives the number of clients, the prompt and output length
distributions, the cache capacity and ``requests_per_s``, the rate the
system was measured to complete such requests at. A run of ``seconds``
sends ``clients + round(seconds * requests_per_s)`` requests, so that the
call lasts about ``seconds``. Every seed gets the same multiset of lengths,
the distribution's quantiles at (i + 1/2) / n, with token ids drawn from
the seed. The order of the lengths is drawn from the seed too, or, where the
mix gives an ``order_seed``, once from that number for every run: in a
closed loop the order decides which completions fall on one engine step and
so how many prefills queue behind each other, so a mix whose tail is an
end-to-end metric fixes it, and seeds change the prompts' tokens and the
weights, not the run's schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    """One request: its prompt's token ids and how many tokens it asks for."""
    prompt: List[int]
    max_new: int


def quantiles(dist: Dict, n: int) -> List[int]:
    """The ``n`` lengths at the quantiles (i + 1/2) / n of ``dist``
    (``loguniform`` or ``uniform`` over [min, max], rounded), each cut to
    ``clip`` where the mix gives one: a document longer than the model's
    window is truncated to it."""
    lo, hi = dist["min"], dist["max"]
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = np.clip(np.rint(x), lo, hi)
    if "clip" in dist:
        x = np.minimum(x, dist["clip"])
    return [int(v) for v in x]


def n_requests(mix: Dict, seconds: float) -> int:
    return mix["clients"] + int(round(seconds * mix["requests_per_s"]))


def requests(mix: Dict, seed: int, seconds: float, vocab: int) -> List[Spec]:
    """The run's requests in the order the clients send them."""
    if mix.get("think_s", 0):
        raise ValueError("only zero think time is generated")
    n = n_requests(mix, seconds)
    rng = np.random.default_rng(seed)
    order = rng if "order_seed" not in mix else np.random.default_rng(mix["order_seed"])
    prompts = order.permutation(quantiles(mix["prompt_tokens"], n))
    outputs = order.permutation(quantiles(mix["output_tokens"], n))
    if max(prompts) + max(outputs) > mix["cap"]:
        raise ValueError(f"cap {mix['cap']} < longest prompt and output")
    return [Spec([int(t) for t in rng.integers(0, vocab, int(p))], int(o))
            for p, o in zip(prompts, outputs)]


def closed_loop_ttft(t_first: List[float], t_done: List[float], clients: int) -> List[float]:
    """Each request's time to first token as its closed-loop client sees it.

    The engine admits in order (first in, first out); a client sends its
    next request the moment its last one completes (zero think time), so
    request ``clients + j`` is sent at the ``j``-th completion. Its TTFT is
    its first token's time less that completion's time. The first
    ``clients`` requests are the loop's opening, sent together: they are
    not in the list (their times, from the call's start, are the opening
    ones). Both lists are in request order, times from the call's start."""
    done = sorted(t for t in t_done if t is not None)
    out = []
    for j, first in enumerate(t_first[clients:]):
        if j >= len(done) or first is None:
            raise ValueError(f"request {clients + j} has no completion to follow")
        out.append(first - done[j])
    return out


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), 95))

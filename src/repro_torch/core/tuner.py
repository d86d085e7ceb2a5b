"""Tuna tuner — the public entry point tying Eq. (1) together:

    argmin_{t ∈ T_e}  c(f(g(e, t), a))

The port's own copy of the search half of ``repro.core.tuner``, held against
it by ``tests/test_torch_core.py``. ``tune(space, target)`` runs the ES
search (Alg. 4) with the static cost model as fitness; ``rank_space``
exhaustively scores a space (used by the top-k benchmark and by the matmul
block picker, whose spaces are small). ``tuned_matmul_blocks`` memoises the
Hopper matmul pick per shape, so ``kernels/ops.matmul`` pays the search once.

The reference's persistence tiers (schedule DB, serving snapshot, kernel
bundle), its learned re-ranker and calibrated coefficients are not ported
yet: every call here searches, and nothing is written anywhere.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import cost_model, es
from repro_torch.core.spaces import MatmulSpace, Space
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.hw.target import HardwareTarget


@dataclasses.dataclass
class TuneResult:
    config: Dict
    score: float
    evaluations: int
    wall_seconds: float
    history: List[float]
    default_score: float  # score of the space's centre config (no tuning)


def _score_config(space: Space, target: HardwareTarget, cfg: Dict) -> float:
    prog, meta = space.instantiate(cfg)
    return cost_model.evaluate(prog, target, meta)


def tune(
    space: Space,
    target: HardwareTarget,
    iterations: int = 12,
    population: int = 16,
    seed: int = 0,
    workers: int = 8,
) -> TuneResult:
    """ES search (Alg. 4) over ``space`` with the static score as fitness;
    each distinct config is scored once."""
    t0 = time.perf_counter()
    cache: Dict[Tuple, float] = {}

    def fitness(theta: np.ndarray) -> float:
        cfg = space.decode(theta)
        key = tuple(sorted(cfg.items()))
        if key not in cache:
            cache[key] = _score_config(space, target, cfg)
        return -cache[key]

    res = es.evolve(
        fitness,
        dim=space.dim,
        iterations=iterations,
        population=population,
        seed=seed,
        workers=workers,
    )
    best_cfg = space.decode(res.best_theta)
    return TuneResult(
        config=best_cfg,
        score=_score_config(space, target, best_cfg),
        evaluations=res.evaluations,
        wall_seconds=time.perf_counter() - t0,
        history=res.history,
        default_score=_score_config(space, target, space.default_config()),
    )


def rank_space(space: Space, target: HardwareTarget,
               limit: int = 4096) -> List[Tuple[Dict, float]]:
    """Static exhaustive ranking (ascending score = predicted fastest first)."""
    scored = [(cfg, _score_config(space, target, cfg))
              for cfg in space.enumerate(limit)]
    scored.sort(key=lambda cs: cs[1])
    return scored


def best_schedule(space: Space, target: HardwareTarget,
                  limit: int = 1024) -> Tuple[Dict, float]:
    """Best (config, score) of an exhaustive static ranking."""
    ranked = rank_space(space, target, limit=limit)
    if not ranked:
        raise ValueError(f"{space.signature()}: the schedule space on "
                         f"{target.name} is empty")
    return ranked[0]


@functools.lru_cache(maxsize=256)
def tuned_matmul_blocks(M: int, N: int, K: int,
                        dtype_bytes: int = 2) -> Tuple[int, int, int, bool]:
    """Statically tuned (bm, bn, bk, double_buffer) for the Hopper matmul
    kernel, memoised per shape.

    Exhaustive over the ``sm90`` matmul space on ``GPU_H100``, whose knobs
    are exactly the tiles the kernel is built for that divide the shape:
    no card is read, as the paper requires. Raises ``ValueError`` when no
    built tile divides one of M, N, K."""
    space = MatmulSpace(M, N, K, dtype_bytes, target_kind=GPU_H100.kind)
    best, _ = best_schedule(space, GPU_H100, limit=1024)
    return best["bm"], best["bn"], best["bk"], best["double_buffer"]

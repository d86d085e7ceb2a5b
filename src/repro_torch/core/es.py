"""Evolution Strategies — paper §IV, Algorithm 4.

The port's own copy of ``repro.core.es``, held against it by
``tests/test_torch_core.py``.

Treats schedule selection as black-box optimization over continuous θ:

    sample ε_1..ε_n ~ N(0, I)
    F_i = F(θ_t + σ ε_i)
    θ_{t+1} = θ_t + α · 1/(nσ) · Σ F_i ε_i

F is *maximised* (we pass negative cost). Population evaluations are
dispatched to a thread pool — the paper's multi-threaded search: static
analysis, unlike on-device measurement, parallelises freely.

Deviations from the bare algorithm: rank-shaped fitness
(standard ES variance reduction), mirrored sampling, and geometric σ decay in
place of the paper's outer black-box tuning of (α, σ).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ESResult:
    best_theta: np.ndarray
    best_fitness: float
    evaluations: int
    history: List[float]  # best-so-far per iteration


def _rank_shape(fs: np.ndarray) -> np.ndarray:
    """Centered rank transform in [-0.5, 0.5]."""
    ranks = np.empty_like(fs)
    ranks[np.argsort(fs)] = np.arange(len(fs))
    if len(fs) <= 1:
        return np.zeros_like(fs)
    return ranks / (len(fs) - 1) - 0.5


def evolve(
    fitness: Callable[[np.ndarray], float],
    dim: int,
    iterations: int = 20,
    population: int = 16,
    alpha: float = 1.0,
    sigma: float = 0.7,
    sigma_decay: float = 0.97,
    seed: int = 0,
    theta0: Optional[np.ndarray] = None,
    workers: int = 8,
    mirrored: bool = True,
) -> ESResult:
    rng = np.random.default_rng(seed)
    theta = np.zeros(dim) if theta0 is None else np.asarray(theta0, float).copy()

    best_theta = theta.copy()
    best_f = -np.inf
    history: List[float] = []
    evals = 0

    pool = cf.ThreadPoolExecutor(max_workers=max(1, workers))
    try:
        for _t in range(iterations):
            half = max(1, population // 2)
            eps = rng.standard_normal((half, dim))
            if mirrored:
                eps = np.concatenate([eps, -eps], axis=0)
            cands = theta[None, :] + sigma * eps
            fs = np.fromiter(
                pool.map(fitness, [c for c in cands]), dtype=float, count=len(cands)
            )
            evals += len(cands)

            i_best = int(np.argmax(fs))
            if fs[i_best] > best_f:
                best_f = float(fs[i_best])
                best_theta = cands[i_best].copy()
            history.append(best_f)

            shaped = _rank_shape(fs)
            theta = theta + alpha / (len(cands) * sigma) * (shaped @ eps)
            sigma = max(0.05, sigma * sigma_decay)
    finally:
        pool.shutdown(wait=False)

    return ESResult(best_theta, best_f, evals, history)

"""Paper Fig. 3/4 on the H100: top-k performance ratio of Tuna's static
ranking against measured ground truth.

    ratio@k = Σ time(measured-best k configs) / Σ time(statically-best k)

(→ 1.0 means the static model picks schedules as good as measuring every
one on the card). The counterpart of the reference's
``benchmarks/topk_ratio.py``: the cost model scores the ``sm90`` matmul
space on the ``gpu_h100`` target with no card involved, then every
candidate runs through the hand-written Hopper kernel and is timed as
device time, by CUDA-graph replay (``measure.py``). When the space is no
larger than ``n_configs`` (the H100 space has at most 24 configs) all of it
is measured, so the oracle is the true measured optimum.

    python -m repro_torch.benchmarks.topk_ratio [--shape M N K]... [--out F]

runs on the card (and raises without one) at the yi-6b projections of a
2048-token prefill by default; ``--device cpu`` times the plain version at
small shapes, which exercises the plumbing and measures nothing of the card.
The reference's calibrated coefficients, schedule-DB write-back and learned
re-ranking are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.measure import measure_config
from repro_torch.core.spaces import MatmulSpace
from repro_torch.core.tuner import _score_config
from repro_torch.hw import resolve_device
from repro_torch.hw.gpu_h100 import GPU_H100

# (M, N, K) of every yi-6b projection for a 2048-token prefill (d_model 4096,
# 4 kv heads of 128, d_ff 11008), then the unembed (vocab 64000)
YI6B_SHAPES = ((2048, 4096, 4096), (2048, 512, 4096), (2048, 11008, 4096),
               (2048, 4096, 11008), (2048, 64000, 4096))
CPU_SHAPES = ((64, 128, 64), (128, 64, 128))


def sample_space(space, n: int, seed: int = 0) -> List[Dict]:
    """The whole space when it has at most ``n`` configs, else a seeded
    random sample of ``n``."""
    cfgs = list(space.enumerate(None))
    return cfgs if len(cfgs) <= n else random.Random(seed).sample(cfgs, n)


def _tkey(cfg: Dict) -> Tuple:
    return tuple(sorted(cfg.items()))


def topk_ratio_matmul(M: int, N: int, K: int, n_configs: int = 128,
                      ks: Sequence[int] = (1, 5, 10), iters: int = 10,
                      seed: int = 0, device="cuda") -> Dict:
    """Static ranking vs measured times over the Hopper matmul space at
    (M, N, K), bf16. Returns ``ratio@k`` for each k, ``top1_ratio``,
    ``best_static_ms``, ``best_oracle_ms``, ``static_s``, ``measure_s``,
    ``n_configs``, ``space_size``, ``rank_corr`` (Spearman's rank
    correlation of static score and measured time over the measured
    configs) and ``ranking``: every measured config with its static score
    and measured ms, in static order."""
    dev = resolve_device(device)
    space = MatmulSpace(M, N, K, 2, target_kind=GPU_H100.kind)
    cfgs = sample_space(space, n_configs, seed)
    if not cfgs:
        raise ValueError(f"{space.signature()}: no built tile divides the shape")

    t0 = time.perf_counter()
    scores = [(cfg, _score_config(space, GPU_H100, cfg)) for cfg in cfgs]
    static_s = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
    t0 = time.perf_counter()
    times = {_tkey(cfg): measure_config(a, b, cfg, iters=iters)
             for cfg, _ in scores}
    measure_s = time.perf_counter() - t0

    by_static = sorted(scores, key=lambda cs: cs[1])
    by_measured = sorted(scores, key=lambda cs: times[_tkey(cs[0])])
    out = {"static_s": static_s, "measure_s": measure_s,
           "n_configs": len(cfgs), "space_size": space.size()}
    for k in ks:
        k = min(k, len(cfgs))
        t_static = sum(times[_tkey(c)] for c, _ in by_static[:k])
        t_oracle = sum(times[_tkey(c)] for c, _ in by_measured[:k])
        out[f"ratio@{k}"] = t_oracle / t_static
    best_static = times[_tkey(by_static[0][0])]
    best_oracle = times[_tkey(by_measured[0][0])]
    out["top1_ratio"] = best_oracle / best_static
    out["best_static_ms"] = best_static * 1e3
    out["best_oracle_ms"] = best_oracle * 1e3
    ranks = [np.argsort(np.argsort(v, kind="stable"), kind="stable")
             for v in ([s for _, s in scores], [times[_tkey(c)] for c, _ in scores])]
    out["rank_corr"] = float(np.corrcoef(*ranks)[0, 1]) if len(cfgs) > 1 else 1.0
    out["ranking"] = [{"config": c, "score": s, "ms": times[_tkey(c)] * 1e3}
                      for c, s in by_static]
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="top-k performance ratio of the static matmul ranking "
                    "against times measured on the card")
    p.add_argument("--shape", nargs=3, type=int, action="append",
                   metavar=("M", "N", "K"),
                   help="matmul shape (repeatable); default: the yi-6b "
                        "prefill projections on cuda, two small shapes on cpu")
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the results as JSON here")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = [tuple(s) for s in args.shape] if args.shape else (
        YI6B_SHAPES if dev.type == "cuda" else CPU_SHAPES)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    results = {}
    for m, n, k in shapes:
        res = topk_ratio_matmul(m, n, k, iters=args.iters, seed=args.seed,
                                device=dev)
        results[f"{m}x{n}x{k}"] = res
        pairs = ", ".join(f"{key}={v:.4f}" for key, v in res.items()
                          if key.startswith(("ratio@", "top1", "best_", "rank_")))
        print(f"{m}x{n}x{k} on {where}: {pairs}, static {res['static_s']:.3f} s, "
              f"measured {res['n_configs']}/{res['space_size']} configs in "
              f"{res['measure_s']:.3f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": where, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

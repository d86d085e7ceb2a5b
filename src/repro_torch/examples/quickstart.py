"""Quickstart: Tuna's static optimization loop (the port of the reference's
``examples/quickstart.py``).

1. Define the operator and its transformation space (Eq. 1's e and T_e):
   the Hopper matmul space at 2048^3 in bf16.
2. Rank it with the ``gpu_h100`` cost model: no card attached, no
   execution.
3. Run the winning schedule as the Hopper matmul kernel at a smaller
   instance and hold it against the oracle (on the CPU, ``--device cpu``,
   the kernel's plain version runs instead).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.spaces import MatmulSpace
from repro_torch.core.tuner import rank_space, tune
from repro_torch.hw import get_target, resolve_device
from repro_torch.kernels import ops, ref


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=2048, help="the tuned M = N = K")
    ap.add_argument("--check-size", type=int, default=256,
                    help="M = N = K of the instance the kernel runs at")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    target = get_target("gpu_h100")
    m = n = k = args.size
    space = MatmulSpace(m, n, k, dtype_bytes=2, target_kind="sm90")
    print(f"space: {space.size()} schedules for {m}x{n}x{k} bf16 matmul")

    # evolution-strategies search with the static cost model as fitness
    res = tune(space, target, iterations=12, population=16, seed=0)
    dflt = ("unknown (warm hit without a stored default_score)"
            if res.default_score_missing else f"{res.default_score:.3e}")
    print(f"ES picked {res.config} score={res.score:.3e} (default schedule: {dflt}; "
          f"{res.evaluations} static evals in {res.wall_seconds:.2f}s)")

    # does the exhaustive static ranking agree?
    best, best_score = rank_space(space, target, limit=512)[0]
    print(f"exhaustive best {best} score={best_score:.3e}")

    ideal = 2 * m * n * k / target.peak_flops_bf16
    print(f"predicted time vs bf16 compute roofline: {res.score / ideal:.2f}x of ideal "
          f"{ideal * 1e6:.1f} us")

    # the winner as a kernel, at a smaller instance, against the oracle
    c = args.check_size
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)
            for s in ((c, c), (c, c)))
    blocks = tuple(min(res.config[b], c) for b in ("bm", "bn", "bk"))
    got = ops.matmul(x, y, blocks=blocks + (res.config["double_buffer"],))
    err = float((got.float() - ref.matmul(x, y).float()).abs().max())
    print(f"kernel at {blocks} on {dev} vs oracle max err: {err:.2e}")
    return {"config": res.config, "score": res.score, "exhaustive_best": best,
            "blocks": blocks, "max_abs_err": err, "device": str(dev)}


if __name__ == "__main__":
    main()

"""Tuna's static ranking against measured times on this machine's device
(the port of the reference's ``examples/tune_operator.py``): the top-k
performance ratio (Fig. 3/4) over a sample of the Hopper matmul space,
measured on the card (on the CPU, ``--device cpu``, the kernel's plain
version is what is timed, which says nothing of the card).

The reference's second half, the compile-time comparison (Table II), needs
the repo-root ``benchmarks/compile_time.py``, whose port is held (ROADMAP
Queue A 5); this example prints the static ranking's and the measurements'
seconds from the top-k run instead.

    PYTHONPATH=src python -m repro_torch.examples.tune_operator --size 384 --configs 16
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.benchmarks.topk_ratio import topk_ratio_matmul


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--configs", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--db", default=None,
                    help="repro_torch.tuna schedule DB to read/write")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.size

    print(f"== top-k performance ratio (matmul {n}^3, {args.configs} candidate "
          f"schedules, {args.device}) ==")
    res = topk_ratio_matmul(n, n, n, n_configs=args.configs, ks=(5, 10), iters=args.iters,
                            db=args.db, device=args.device)
    for key, v in res.items():
        if key.endswith("ranking"):
            continue
        print(f"  {key}: {v:.4f}" if isinstance(v, float) else f"  {key}: {v}")
    print(f"== static ranking {res['static_s']:.3f}s against measuring "
          f"{res['n_configs']} configs {res['measure_s']:.3f}s ==")
    return res


if __name__ == "__main__":
    main()

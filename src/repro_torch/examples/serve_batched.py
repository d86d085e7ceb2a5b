"""Batched serving example: prefill and decode over a stream of requests
(the port of the reference's ``examples/serve_batched.py``), a reduced
model with weights from a seeded generator.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch yi-6b --requests 6
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.serve import Request, serve
from repro_torch.models.model import Model


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len)],
                    args.max_new) for i in range(args.requests)]
    stats = serve(model, params, reqs, slots=args.slots,
                  cap=args.prompt_len + args.max_new + 2)
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt {r.prompt[:6]}... -> {r.out}")
    print(f"{stats['tokens']} tokens, {stats['tok_per_s']:.1f} tok/s, "
          f"{stats['engine_steps']} engine steps")
    return {"outputs": [list(r.out) for r in reqs], "stats": stats}


if __name__ == "__main__":
    main()

"""End-to-end training example (the port of the reference's
``examples/train_tiny.py``): a reduced model trained on learnable periodic
data, so the loss visibly collapses, or, with ``--full-loop``, the
fault-tolerant production loop (deterministic data, async checkpoints,
failure recovery, straggler monitoring).

    PYTHONPATH=src python -m repro_torch.examples.train_tiny --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_tiny --arch jamba-v0.1-52b --steps 50
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainOptions, train_with_recovery
from repro_torch.models.model import Model
from repro_torch.optim import adamw


def learnable_demo(arch: str, steps: int, device: str) -> Dict:
    """Loss-collapse demo on periodic data (the next token is fully
    predictable)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device=device)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    state = adamw.init_state(opt_cfg, params)
    base = (torch.arange(65, dtype=torch.int32) * 7) % cfg.vocab
    toks = base[None].repeat(8, 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(model, opt_cfg)
    ces = []
    for i in range(steps):
        params, state, metrics = step(params, state, batch)
        ces.append(float(metrics["ce"]))
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"step {i:4d}  ce {ces[-1]:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.2f}")
    print(f"final ce {ces[-1]:.4f} (random floor {math.log(cfg.vocab):.2f})")
    return {"ce": ces, "floor": math.log(cfg.vocab)}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-loop", action="store_true",
                    help="use the fault-tolerant production loop instead")
    ap.add_argument("--ckpt-dir", default=None,
                    help="the full loop's checkpoints (default: none kept)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full_loop:
        cfg = get_config(args.arch).reduced()
        out = train_with_recovery(cfg, TrainOptions(
            steps=args.steps, batch=8, seq=64, ckpt_dir=args.ckpt_dir,
            ckpt_every=50, log_every=20, device=args.device))
        print("final step", out["final_step"])
        return {"final_step": out["final_step"],
                "losses": [loss for _, loss, _ in out["history"]]}
    return learnable_demo(args.arch, args.steps, args.device)


if __name__ == "__main__":
    main()

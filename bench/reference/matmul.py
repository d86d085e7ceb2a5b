"""The plain reference of a product C = A B: float32 with TF32 off; with
``precision="fp8"`` (the control) both operands are first rounded to
float8 e4m3, per row of A and per column of B."""
from __future__ import annotations

import torch

from reference.decoder import _fp8


def product(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = a.float(), b.float()
    if precision == "fp8":
        a, b = _fp8(a, -1), _fp8(b, 0)
    elif precision != "f32":
        raise ValueError(f"precision {precision!r}")
    return a @ b


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest element error over the largest reference element."""
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))

"""The kernels' aligned staging copy: an operand TMA cannot address as it is,
copied into a buffer it can.

TMA steps a tensor's rows by a global stride that must be a multiple of 16
bytes, from a base address that must be 16-byte aligned, and the kernels
take their operands contiguous. An operand that breaks any of these (a row
of 20 bf16 elements, 40 bytes; a transposed view; a view at an odd
offset) is copied into a fresh contiguous buffer whose last dimension is
zero-padded to a multiple of 16 bytes (``staged``). The zero columns are
what make the padded problem the caller's: zero columns of Q and K add
exactly 0 to Q Kᵀ, zero columns of V give output columns that are dropped,
and zero columns of A meet zero rows of B.

An operand that needs no copy is passed as it is: the fast path makes no
copy and no allocation. A padded output is copied back to the caller's
width (``unstaged``). Every launch that staged an operand is counted per
kernel family, with the bytes of the buffers it wrote (``STAGED``,
``STAGED_BYTES``; ``ops.stage_counts``), and the copies run under a
``spans.span`` of their own (``flash.stage``, ``matmul.stage``) so that a
profile attributes them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.spans import span

ALIGN = 16  # bytes: TMA's global row stride and base alignment
# launches that staged at least one operand, and the bytes of the staged
# buffers they wrote, per kernel family; reset via ``ops.reset_launch_counts``
STAGED: Dict[str, int] = {"flash_attention": 0, "matmul": 0}
STAGED_BYTES: Dict[str, int] = {"flash_attention": 0, "matmul": 0}
SPAN = {"flash_attention": "flash.stage", "matmul": "matmul.stage"}


def aligned_cols(n: int, elem_bytes: int) -> int:
    """The smallest row length of at least ``n`` elements whose bytes are a
    multiple of 16: the width a staged buffer's last dimension gets."""
    per = ALIGN // elem_bytes
    return -(-n // per) * per


def needs_copy(t: torch.Tensor, shape: Sequence[int]) -> bool:
    """Whether ``t`` cannot go to a kernel as the ``shape`` operand (whose
    rows the caller sized to TMA's stride) as it is: another shape
    (padding), a non-contiguous layout or a base that is not 16-byte
    aligned."""
    return (tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % ALIGN != 0)


def staged(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t`` in a fresh contiguous buffer of ``shape`` (each dimension at
    least ``t``'s), zero where ``t`` has no element."""
    if tuple(shape) == tuple(t.shape):
        buf = torch.empty(tuple(shape), dtype=t.dtype, device=t.device)
    else:
        buf = torch.zeros(tuple(shape), dtype=t.dtype, device=t.device)
    buf[tuple(slice(0, n) for n in t.shape)].copy_(t)
    return buf


def stage(kernel: str, operands: Sequence[torch.Tensor],
          shapes: Sequence[Sequence[int]]) -> list:
    """Each operand as the kernel may take it as the matching shape: the
    operand itself where it needs no copy, else its staged copy. Counts the
    launch under ``kernel`` when it copied anything."""
    if not any(needs_copy(t, s) for t, s in zip(operands, shapes)):
        return list(operands)
    out, nbytes = [], 0
    with span(SPAN[kernel]):
        for t, s in zip(operands, shapes):
            if needs_copy(t, s):
                t = staged(t, s)
                nbytes += t.numel() * t.element_size()
            out.append(t)
    STAGED[kernel] += 1
    STAGED_BYTES[kernel] += nbytes
    return out


def unstaged(kernel: str, out: torch.Tensor, cols: int) -> torch.Tensor:
    """The first ``cols`` columns of a kernel's padded output, copied into a
    contiguous tensor (the caller's shape and layout; a view would carry the
    padded row stride into autograd and later in-place ops), the bytes
    counted with the launch's staging. ``out`` as it is when unpadded."""
    if out.shape[-1] == cols:
        return out
    with span(SPAN[kernel]):
        res = out[..., :cols].contiguous()
    STAGED_BYTES[kernel] += res.numel() * res.element_size()
    return res

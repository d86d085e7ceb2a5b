"""Mixture-of-Experts MLP: top-k routing, capacity-bounded gather dispatch
and a gather-and-reduce combine (the port of ``repro.models.moe``).

Per batch row, each expert receives a capacity-``C`` gather of token vectors
(no ``[T, E, C]`` one-hot); the expert products are two batched einsums over
the expert axis (cuBLAS); the combine gathers each token's k weighted slot
outputs back and sums them in f32, in the order of the token's top-k, then
rounds once to the compute dtype. It has no atomics, so it gives the same
bits on every run, as the reference's XLA scatter-add does. Assignments
ranked past the capacity are dropped (Switch style), bounded by
``capacity_factor``.

On a device mesh (DTensor activations) the router and the expert products
run on DTensors, the experts over ``model`` (EP); the dispatch plan, the
token gather and the combine, whose index ops have no DTensor strategy, run
on each rank's batch rows (``pctx.map_rows``), the slot outputs gathered
over the experts first. With ``pctx.moe_pin()`` the reference's five
constraints pin the plan and the ``[B, E, C, *]`` activations. Without a
mesh all of these are plain calls and no-ops.

Aux loss: Switch load-balancing  E · Σ_e f_e · P_e.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import context as pctx


def init_moe(cfg, gen, lead: Tuple[int, ...] = ()) -> Dict:
    """The router, the experts' ``w1``/``w2`` and, for the gated activations
    (``swiglu``, ``geglu``), ``w3``, drawn from ``gen`` in that order."""
    moe = cfg.moe
    d, fe, e = cfg.d_model, moe.d_expert, moe.n_experts
    dt = cfg.torch_param_dtype()
    sc_in, sc_out = d ** -0.5, fe ** -0.5
    p = {
        "router": L.normal(gen, lead + (d, e), sc_in, dt),
        "w1": L.normal(gen, lead + (e, d, fe), sc_in, dt),
        "w2": L.normal(gen, lead + (e, fe, d), sc_out, dt),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = L.normal(gen, lead + (e, d, fe), sc_in, dt)
    if moe.shared_expert:
        p["shared"] = L.init_dense_mlp(cfg, gen, lead, d_ff=fe)
    return p


def route(cfg, p: Dict, x: torch.Tensor):
    """x [B,S,D] -> (topk_idx [B,S,k], gates [B,S,k], aux_loss scalar).

    The top k are taken from a stable descending sort, so that equal
    probabilities go to the lower expert index first, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order on ties)."""
    moe = cfg.moe
    with L.span("moe.route"):
        # the logits with every dim but the batch whole: the softmax, sort
        # and aux loss below then return their gradient in that placement
        logits = pctx.batch_only(x.float() @ p["router"].float())  # [B,S,E]
        probs = torch.softmax(logits, dim=-1)
        srt = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = srt.values[..., :moe.top_k], srt.indices[..., :moe.top_k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        # Switch aux loss: fraction of tokens per expert x mean router prob
        e = moe.n_experts
        f = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
        pbar = probs.mean(dim=(0, 1))
        aux = e * torch.sum(f * pbar)
    return idx, gates.to(x.dtype), aux


def ranks(flat_e: torch.Tensor) -> torch.Tensor:
    """flat_e [B, N] expert ids -> each assignment's rank among the equal ids
    before it in its row: a stable sort plus a segment-start cummax, O(N)
    memory (the reference's ``ranks_one``). A function of the ids only, the
    same on every device."""
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    ar = torch.arange(n, device=flat_e.device).expand_as(flat_e)
    is_start = torch.ones_like(flat_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    return torch.empty_like(flat_e).scatter_(1, order, ar - seg_start)


def dispatch_plan(idx: torch.Tensor, gates: torch.Tensor, cap: int,
                  n_experts: int, dtype: torch.dtype):
    """Capacity assignment per batch row.

    idx/gates [B, S, k] -> (dispatch_idx [B, E, C] source token of each
    capacity slot (0 if unused), slot_w [B, E, C] its gate (0 if unused),
    keep [B, S*k] which assignments got a slot, emptied [B] whether slot
    (0, 0) was emptied as the reference empties it, slot [B, S*k] each
    assignment's flat slot ``e * C + min(pos, C - 1)``, valid where kept)."""
    b, s, k = idx.shape
    e = n_experts
    flat_e = idx.reshape(b, s * k)
    pos = ranks(flat_e)
    keep = pos < cap
    ar = torch.arange(s * k, device=idx.device)
    token_of_slot = (ar // k).expand(b, -1)
    # Write only the kept assignments: a dropped one goes to an overflow
    # slot C of its expert, which is cut off below, so no kept slot depends
    # on the order in which duplicate indices are applied.
    lin = flat_e * (cap + 1) + pos.clamp_max(cap)
    dispatch_idx = torch.zeros((b, e * (cap + 1)), dtype=torch.long, device=idx.device)
    dispatch_idx.scatter_(1, lin, token_of_slot)
    slot_w = torch.zeros((b, e * (cap + 1)), dtype=dtype, device=idx.device)
    slot_w.scatter_(1, lin, gates.reshape(b, s * k).to(dtype))
    dispatch_idx = dispatch_idx.view(b, e, cap + 1)[:, :, :cap]
    slot_w = slot_w.view(b, e, cap + 1)[:, :, :cap]
    # The reference (src/repro/models/moe.py:96-103) scatters every dropped
    # assignment to (expert 0, slot 0) <- (token 0, gate 0), and XLA applies
    # the writes in order, so a drop after the row's first assignment to
    # expert 0 overwrites that kept slot and the token loses expert 0's
    # contribution. The port reproduces this on purpose and explicitly
    # (ROADMAP Queue C lists it as a defect of the reference).
    first0 = torch.where(flat_e == 0, ar, s * k).amin(dim=1)
    last_drop = torch.where(keep, -1, ar).amax(dim=1)
    emptied = last_drop > first0
    dispatch_idx[:, 0, 0] = torch.where(emptied, 0, dispatch_idx[:, 0, 0])
    slot_w[:, 0, 0] = torch.where(emptied, 0, slot_w[:, 0, 0])
    slot = flat_e * cap + pos.clamp_max(cap - 1)
    return dispatch_idx, slot_w, keep, emptied, slot


def _gather_slots(x: torch.Tensor, dispatch_idx: torch.Tensor,
                  slot_w: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    xin = x[rows, dispatch_idx]  # [B,E,C,D]
    return xin * (slot_w[..., None] != 0)  # zero out unused slots


def expert_outputs(cfg, p: Dict, x: torch.Tensor, dispatch_idx: torch.Tensor,
                   slot_w: torch.Tensor) -> torch.Tensor:
    """The gate-weighted expert output of every capacity slot, [B, E, C, D]
    in the compute dtype; 0 in an unused or emptied slot."""
    cd = cfg.torch_compute_dtype()
    with L.span("moe.gather_scatter"):
        xin = pctx.map_rows(_gather_slots, (x, dispatch_idx, slot_w), (True,) * 3)
    if pctx.moe_pin():
        xin = pctx.constrain_dims(xin, ("dp", "tp", None, None))
    with L.span("moe.experts"):
        xc = xin.to(cd)
        h = torch.einsum("becd,edf->becf", xc, p["w1"].to(cd))
        if pctx.moe_pin():
            h = pctx.constrain_dims(h, ("dp", "tp", None, None))
        g = (torch.einsum("becd,edf->becf", xc, p["w3"].to(cd))
             if "w3" in p else None)
        out = torch.einsum("becf,efd->becd", L._act(cfg, h, g), p["w2"].to(cd))
        if pctx.moe_pin():
            out = pctx.constrain_dims(out, ("dp", "tp", None, None))
        return out * slot_w[..., None]


def combine(out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            k: int) -> torch.Tensor:
    """out [B, E, C, D], slot/keep [B, S*k] -> y [B, S, D] in out's dtype.

    Gathers each assignment's slot output (0 where it was dropped), then
    sums a token's k contributions in f32 from the first to the last of its
    top-k and rounds once. A token whose slot the reference emptied gathers
    the 0 that ``dispatch_plan`` left there."""
    b, e, c, d = out.shape
    rows = torch.arange(b, device=out.device)[:, None]
    picked = out.reshape(b, e * c, d)[rows, slot]  # [B, S*k, D]
    picked = torch.where(keep[..., None], picked, 0).view(b, -1, k, d)
    y = picked[:, :, 0].float()
    for j in range(1, k):
        y = y + picked[:, :, j].float()
    return y.to(out.dtype)


def apply_moe(cfg, p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,D], aux_loss)."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    cap = max(1, int(s * k * moe.capacity_factor / e))
    cd = cfg.torch_compute_dtype()

    idx, gates, aux = route(cfg, p, x)
    with L.span("moe.route"):
        dispatch_idx, slot_w, keep, _, slot = pctx.map_rows(
            lambda i, g: dispatch_plan(i, g, cap, e, cd), (idx, gates), (True, True),
            n_out=5)
    if pctx.moe_pin():
        dispatch_idx = pctx.constrain_dims(dispatch_idx, ("dp", None, None))
        slot_w = pctx.constrain_dims(slot_w, ("dp", None, None))
    out = expert_outputs(cfg, p, x, dispatch_idx, slot_w)
    with L.span("moe.gather_scatter"):
        y = pctx.map_rows(lambda o, sl, kp: combine(o, sl, kp, k), (out, slot, keep),
                          (True,) * 3)
    if pctx.moe_pin():
        y = pctx.constrain_dims(y, ("dp", None, None))

    if moe.shared_expert:
        with L.span("moe.experts"):
            y = y + L.apply_dense_mlp(cfg, p["shared"], x).to(cd)
    return y.to(x.dtype), aux.float()

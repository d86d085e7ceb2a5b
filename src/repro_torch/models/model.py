"""Model facade: init / logits / prefill / decode for the decoder-only
families the port serves (dense, MoE, and the attention/mamba hybrid).

Batch schema: ``{"tokens": [B, S] int}`` on the model's device. The decode
cache is a tuple with one dict per pattern position: ``{"k", "v"}`` leaves
``[G, B, Hkv, cap, dh]`` for attention, ``{"conv", "h"}`` leaves
``[G, B, K-1, d_inner]`` and ``[G, B, d_inner, N]`` for mamba.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.hw import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    cfg: Any
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters drawn from ``generator`` (on the model's device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        return {"embed": L.init_embed(cfg, generator),
                "norm_f": L.init_norm(cfg, self.device),
                "layers": T.init_stack(cfg, generator)}

    # --------------------------------------------------------------- forward
    def _embed_inputs(self, params, batch):
        x = L.embed(self.cfg, params["embed"], batch["tokens"])
        return x, torch.arange(x.shape[1], device=x.device)

    def forward_hidden(self, params, batch) -> torch.Tensor:
        x, pos = self._embed_inputs(params, batch)
        x, _ = T.apply_stack(self.cfg, params["layers"], x, pos, causal=True)
        return L.apply_norm(self.cfg, params["norm_f"], x)

    def logits(self, params, batch) -> torch.Tensor:
        return L.unembed(self.cfg, params["embed"],
                         self.forward_hidden(params, batch))

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, cap: int) -> Tuple:
        return T.init_stack_cache(self.cfg, batch, cap, self.device)

    def prefill(self, params, batch, cap: int):
        """Run the prompt and build a decode cache of capacity ``cap``: the
        prompt's k/v land in ``[..., :S, :]`` and the rest stays zero; each
        mamba layer holds its state after the prompt.
        Returns (cache, pos_next, last_logits [B, 1, V])."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params, batch)
        s_total = x.shape[1]
        if cap < s_total:
            raise ValueError(f"cache capacity {cap} < prompt length {s_total}")
        cache = self.init_cache(x.shape[0], cap)
        x, _ = T.apply_stack(cfg, params["layers"], x, pos, causal=True,
                             cache=cache)
        x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
        last_logits = L.unembed(cfg, params["embed"], x)
        return cache, torch.tensor(s_total, dtype=torch.int32), last_logits

    def decode_step(self, params, cache, token: torch.Tensor, pos: torch.Tensor):
        """token [B] int; pos 0-dim (all rows at one depth) or [B] (per-slot
        depths), every entry below the attention cache's capacity. Writes
        the new k/v and mamba states into ``cache`` in place. Returns
        (logits [B, V], cache)."""
        cfg = self.cfg
        cap = next((c["k"].shape[3] for c in cache if "k" in c), None)
        if int(pos.min()) < 0 or (cap is not None and int(pos.max()) >= cap):
            raise ValueError(f"decode position out of the cache [0, {cap})")
        pos = pos.to(self.device)
        x = L.embed(cfg, params["embed"], token.to(self.device)[:, None])
        x = T.apply_stack_decode(cfg, params["layers"], x, cache, pos)
        x = L.apply_norm(cfg, params["norm_f"], x)
        return L.unembed(cfg, params["embed"], x)[:, 0], cache

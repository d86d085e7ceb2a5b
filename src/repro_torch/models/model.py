"""Model facade: init / logits / prefill / decode for every arch family of
the reference: decoder-only (dense, MoE, the attention/mamba hybrid and the
xLSTM stack), the encoder-decoder and the vision prefix.

Batch schema: ``{"tokens": [B, S] int}`` (``Model.loss`` adds ``"labels"``
[B, S] int) on the model's device; the audio
family adds ``"frames"`` ``[B, n_frontend_tokens, D]`` (the encoder's input)
and the vision family ``"patches"`` ``[B, n_frontend_tokens, D]`` (a prefix
before the tokens). Both frontends are stubs, as in the reference: the
embeddings are given.

The decode cache is a tuple with one dict per pattern position, every leaf
``[G, B, ...]``: ``{k, v}`` ``[G, B, Hkv, cap, dh]`` for attention, ``{conv,
h}`` ``[G, B, K-1, d_inner]`` and ``[G, B, d_inner, N]`` for mamba, ``{C, n,
m}`` ``[G, B, H, dh, dh]``, ``[G, B, H, dh]`` and ``[G, B, H]`` for mLSTM,
``{c, n, h, m}`` each ``[G, B, D]`` for sLSTM, and for the encoder-decoder
``{xk, xv}`` ``[G, B, Hkv, n_frontend_tokens, dh]``, the encoder's
projections, written at prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.hw import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import context as pctx

ENC_PATTERN = (("attention", "dense"),)


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
        dt = cfg.torch_param_dtype()
        params = {"embed": L.init_embed(cfg, generator),
                  "norm_f": L.init_norm(cfg, self.device),
                  "layers": T.init_stack(cfg, generator, cross=cfg.encoder_decoder)}
        if cfg.encoder_decoder:
            params["encoder"] = T.init_stack(cfg, generator, n_layers=cfg.n_encoder_layers,
                                             pattern=ENC_PATTERN)
            params["enc_norm_f"] = L.init_norm(cfg, self.device)
            params["enc_pos"] = L.normal(generator, (cfg.n_frontend_tokens, cfg.d_model),
                                         0.02, dt)
        if cfg.frontend == "vision":
            params["vis_proj"] = L.normal(generator, (cfg.d_model, cfg.d_model),
                                          cfg.d_model ** -0.5, dt)
        return params

    # --------------------------------------------------------------- forward
    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over the stub frame embeddings [B, T, D]: non-causal
        attention with RoPE over the frame positions."""
        cfg = self.cfg
        cd = cfg.torch_compute_dtype()
        x = frames.to(self.device, cd) + params["enc_pos"].to(cd)
        pos = torch.arange(frames.shape[1], device=self.device)
        x, _ = T.apply_stack(cfg, params["encoder"], x, pos, causal=False,
                             pattern=ENC_PATTERN)
        return L.apply_norm(cfg, params["enc_norm_f"], x)

    def _enc_out(self, params, batch):
        return self._encode(params, batch["frames"]) if self.cfg.encoder_decoder else None

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Returns (x [B, S_total, D], positions, n_prefix): the projected
        patches, where the arch has them, come before the tokens."""
        cfg = self.cfg
        x = L.embed(cfg, params["embed"], batch["tokens"])
        n_prefix = 0
        if cfg.frontend == "vision":
            cd = cfg.torch_compute_dtype()
            patches = batch["patches"].to(self.device, cd) @ params["vis_proj"].to(cd)
            x = torch.cat([patches, x], dim=1)
            n_prefix = patches.shape[1]
        return pctx.constrain_tokens(x), torch.arange(x.shape[1], device=x.device), n_prefix

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics): the mean next-token cross-entropy over the
        tokens (the vision prefix's positions cut before it), plus for MoE
        ``router_aux_weight`` times the summed Switch aux loss; metrics
        ``ce``, ``loss`` and for MoE ``aux``, as the reference returns them."""
        cfg = self.cfg
        enc_out = self._enc_out(params, batch)
        x, pos, n_prefix = self._embed_inputs(params, batch)
        x, aux = T.apply_stack(cfg, params["layers"], x, pos, causal=True,
                               enc_out=enc_out)
        x = L.apply_norm(cfg, params["norm_f"], x)
        if n_prefix:
            x = x[:, n_prefix:]
        ce = L.cross_entropy_loss(cfg, params["embed"], x, batch["labels"])
        total = ce
        metrics = {"ce": ce}
        if cfg.moe is not None:
            total = total + cfg.moe.router_aux_weight * aux
            metrics["aux"] = aux
        metrics["loss"] = total
        return total, metrics

    def forward_hidden(self, params, batch) -> torch.Tensor:
        enc_out = self._enc_out(params, batch)
        x, pos, _ = self._embed_inputs(params, batch)
        x, _ = T.apply_stack(self.cfg, params["layers"], x, pos, causal=True,
                             enc_out=enc_out)
        return L.apply_norm(self.cfg, params["norm_f"], x)

    def logits(self, params, batch) -> torch.Tensor:
        """[B, S, V] over the tokens (the vision prefix's positions dropped)."""
        x = self.forward_hidden(params, batch)
        n_prefix = self.cfg.n_frontend_tokens if self.cfg.frontend == "vision" else 0
        return L.unembed(self.cfg, params["embed"], x[:, n_prefix:])

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, cap: int) -> Tuple:
        cfg = self.cfg
        cross_len = cfg.n_frontend_tokens if cfg.encoder_decoder else 0
        return T.init_stack_cache(cfg, batch, cap, self.device, cross_len=cross_len)

    def prefill(self, params, batch, cap: int):
        """Run the prompt (after the vision prefix, where the arch has one)
        and build a decode cache of capacity ``cap`` >= the prefix and the
        prompt: their k/v land in ``[..., :S_total, :]`` and the rest stays
        zero; each recurrent layer holds its state after the prompt; the
        encoder-decoder's ``{xk, xv}`` hold the encoder's projections.
        Every leaf is placed by its key, whatever its shape.
        Returns (cache, pos_next = S_total, last_logits [B, 1, V])."""
        cfg = self.cfg
        enc_out = self._enc_out(params, batch)
        x, pos, _ = self._embed_inputs(params, batch)
        s_total = x.shape[1]
        if cap < s_total:
            raise ValueError(f"cache capacity {cap} < prefix and prompt length {s_total}")
        cache = self.init_cache(x.shape[0], cap)
        x, _ = T.apply_stack(cfg, params["layers"], x, pos, causal=True,
                             cache=cache, enc_out=enc_out)
        x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
        last_logits = L.unembed(cfg, params["embed"], x)
        return cache, torch.tensor(s_total, dtype=torch.int32), last_logits

    def decode_step(self, params, cache, token: torch.Tensor, pos: torch.Tensor):
        """token [B] int; pos 0-dim (all rows at one depth) or [B] (per-slot
        depths), every entry below the attention cache's capacity. Writes
        the new k/v and recurrent states into ``cache`` in place. Returns
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

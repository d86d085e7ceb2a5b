"""The plain reference of the training step of a dense decoder: float32
math with TF32 off, layer by layer, importing nothing of the program.

The loss is the mean next-token cross-entropy over every row and position
of the batch; the gradients come from autograd over one layer at a time
(the forward keeps only each layer's input; the backward runs each layer
again), so one layer's activations live at a time. The optimizer is AdamW
with a global-norm clip, as the configuration states it: the math in f32,
the parameters and both moments stored between steps in the configuration's
dtype (bf16), the update of a step taken from its unrounded moments.

``precision="fp8"`` is the control: every product with a weight takes both
operands rounded to float8 e4m3 in the forward (and in the layer's run
again in the backward), the gradient passing through the rounding.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from reference.decoder import _fp8, head_dim, rope

LAYER_KEYS = (("norm1", "w"), ("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
              ("mixer", "wo"), ("norm2", "w"), ("mlp", "w1"), ("mlp", "w2"), ("mlp", "w3"))


class Lin:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x, w):
        if self.fp8:
            x = x + (_fp8(x.detach(), -1) - x).detach()
            w = w + (_fp8(w.detach(), 0) - w).detach()
        return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def block(c: Dict, p: Dict, x: torch.Tensor, lin: Lin) -> torch.Tensor:
    """One dense decoder layer over x [B, S, D] (f32)."""
    b, s, d = x.shape
    hq, hkv, dh = c["num_attention_heads"], c["num_key_value_heads"], head_dim(c)
    g = hq // hkv
    eps, theta = c["rms_norm_eps"], c.get("rope_theta", 10000.0)
    h = _rms(x, p["norm1.w"], eps)
    q = lin(h, p["mixer.wq"]).view(b, s, hq, dh).transpose(1, 2)
    k = lin(h, p["mixer.wk"]).view(b, s, hkv, dh).transpose(1, 2)
    v = lin(h, p["mixer.wv"]).view(b, s, hkv, dh).transpose(1, 2)
    q = torch.stack([rope(q[i], theta) for i in range(b)])
    k = torch.stack([rope(k[i], theta) for i in range(b)])
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    outs = []
    for j in range(hkv):
        sc = q[:, j * g:(j + 1) * g] @ k[:, j:j + 1].transpose(-1, -2) * dh ** -0.5
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append(torch.softmax(sc, dim=-1) @ v[:, j:j + 1])
    att = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, s, hq * dh)
    x = x + lin(att, p["mixer.wo"])
    h = _rms(x, p["norm2.w"], eps)
    return x + lin(F.silu(lin(h, p["mlp.w1"])) * lin(h, p["mlp.w3"]), p["mlp.w2"])


def loss_and_grads(c: Dict, weights: Callable[[str, int], torch.Tensor], batch: Dict,
                   precision: str = "f32", on_grad: Optional[Callable] = None
                   ) -> Tuple[float, Dict[Tuple[str, int], torch.Tensor]]:
    """(loss, grads): ``weights(name, i)`` gives layer ``i``'s leaf ``name``
    (``"mixer.wq"``; i = -1 for the leaves outside the stack: ``embed.tok``,
    ``embed.head``, ``norm_f.w``) in f32; grads are keyed the same way.
    With ``on_grad`` each gradient is handed to it as it is made and not
    kept (the dict comes back empty)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lin = Lin(precision)
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    n_layers = c["num_hidden_layers"]
    names = [f"{a}.{b}" for a, b in LAYER_KEYS]
    grads: Dict[Tuple[str, int], torch.Tensor] = {}

    def done(key, g):
        if on_grad is None:
            grads[key] = g
        else:
            on_grad(key, g)
    with torch.no_grad():
        xs = [weights("embed.tok", -1)[tokens]]
        for i in range(n_layers):
            xs.append(block(c, {n: weights(n, i) for n in names}, xs[-1], lin))
    x = xs.pop().requires_grad_(True)
    nf = weights("norm_f.w", -1).requires_grad_(True)
    head = weights("embed.head", -1).requires_grad_(True)
    logits = lin(_rms(x, nf, c["rms_norm_eps"]), head)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    loss.backward()
    done(("norm_f.w", -1), nf.grad)
    done(("embed.head", -1), head.grad)
    gx = x.grad
    del logits, x, nf, head
    for i in reversed(range(n_layers)):
        xi = xs.pop().requires_grad_(True)
        p = {n: weights(n, i).requires_grad_(True) for n in names}
        block(c, p, xi, lin).backward(gx)
        for n in names:
            done((n, i), p[n].grad)
        gx = xi.grad
        del p, xi
    tok = torch.zeros(c["vocab_size"], gx.shape[-1], device=gx.device)
    tok.index_add_(0, tokens.reshape(-1), gx.reshape(-1, gx.shape[-1]))
    done(("embed.tok", -1), tok)
    return float(loss.detach()), grads


class AdamW:
    """AdamW with a global-norm clip; state stored in ``dtype`` between
    steps, the math in f32."""

    def __init__(self, lr, b1, b2, eps, weight_decay, grad_clip, dtype=torch.bfloat16):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.dtype = weight_decay, grad_clip, dtype

    def clip_factor(self, sumsq: float) -> float:
        """The clip's factor for gradients whose squares sum to ``sumsq``."""
        return min(1.0, self.clip / max(sumsq ** 0.5, 1e-12))

    def update(self, p, g, m, v, t: int):
        """One step on one leaf: f32 tensors ``p`` (the stored value), ``g``
        (clipped), the stored moments ``m``, ``v`` (None at step 1).
        Returns the new stored (p, m, v)."""
        m = self.b1 * (0 if m is None else m) + (1 - self.b1) * g
        v = self.b2 * (0 if v is None else v) + (1 - self.b2) * g * g
        upd = (m / (1 - self.b1 ** t)) / (torch.sqrt(v / (1 - self.b2 ** t)) + self.eps)
        upd = upd + self.wd * p
        rd = lambda z: z.to(self.dtype).float()
        return rd(p - self.lr * upd), rd(m), rd(v)

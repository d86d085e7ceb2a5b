"""Model FLOPs of the traced training steps (three times the forward:
two per weight multiplied, the causal attention and the unembedding; the
remat recompute not counted) over the traced stretch at the bf16 peak."""


def read(r):
    t, c, w = r.trace, r.config, r.work
    steps = len(r.calls.get("steps") or [])
    if t is None or not steps or not t.kernels or not t.window_s:
        return None
    flops = steps * w.train_flops(c, r.calls["rows"], r.calls["tokens"])
    return 100.0 * flops / (t.window_s * w.PEAKS["bf16_flops"])

"""Model FLOPs of the traced stretch's prefills and decode steps (live
slots only, two per weight multiplied and the attention over each
token's context) over the stretch's length at the bf16 peak."""


def read(r):
    t, c, w = r.trace, r.config, r.work
    if t is None or not t.window_s or not t.kernels:
        return None
    flops = sum(w.prefill_flops(c, s) for s in r.calls.get("prefills", []))
    flops += sum(w.decode_flops(c, step) for step in r.calls.get("decodes", []))
    return 100.0 * flops / (t.window_s * w.PEAKS["bf16_flops"])

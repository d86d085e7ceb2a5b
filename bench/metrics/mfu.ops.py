"""FLOPs of the traced passes over the traced stretch at the bf16 peak:
the whole pass's share of the chip, launch gaps included."""


def read(r):
    t, w = r.trace, r.work
    passes = len(r.calls.get("passes") or [])
    if t is None or not passes or not t.window_s or not t.kernels:
        return None
    flops = passes * sum(w.matmul_work(m, n, k)[0] for m, n, k in r.calls["shapes"])
    return 100.0 * flops / (t.window_s * w.PEAKS["bf16_flops"])

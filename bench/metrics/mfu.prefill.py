"""Model FLOPs of the traced stretch's prefills over their device time
(the ``bench.prefill`` ranges) at the bf16 peak: the whole prefill step's
share of the chip, which bounds what a faster flash kernel can give."""


def read(r):
    t, c, w = r.spans, r.config, r.work
    prefills = r.span_calls.get("prefills") or []
    if t is None or not prefills or not t.kernels or not t.span_ms.get("bench.prefill"):
        return None
    flops = sum(w.prefill_flops(c, s) for s in prefills)
    return 100.0 * flops / (t.span_ms["bench.prefill"] / 1e3 * w.PEAKS["bf16_flops"])

"""Device ms per prefill: the kernels launched inside the harness's
``bench.prefill`` ranges around ``Model.prefill`` in the traced stretch,
over the number of prefills there (the stretch with the host's ranges)."""


def read(r):
    t = r.spans
    if t is None or not t.span_count.get("bench.prefill") or "bench.prefill" not in t.span_ms:
        return None
    return t.span_ms["bench.prefill"] / t.span_count["bench.prefill"]

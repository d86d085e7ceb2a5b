"""Device ms per decode step: the kernels launched inside the harness's
``bench.decode_step`` ranges around ``Model.decode_step`` in the traced
stretch with the host's ranges, over the number of steps there."""


def read(r):
    t = r.spans
    if t is None or not t.span_count.get("bench.decode_step") \
            or "bench.decode_step" not in t.span_ms:
        return None
    return t.span_ms["bench.decode_step"] / t.span_count["bench.decode_step"]

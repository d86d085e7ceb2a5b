"""Share of the traced stretch's device time spent in the program's
``mamba`` ranges (``models/ssm.py``, prefill scan and decode recurrence)."""


def read(r):
    t = r.spans
    if t is None or not t.span_ms.get("mamba"):
        return None
    return 100.0 * (t.span_ms["mamba"] / 1e3) / t.kernel_s()

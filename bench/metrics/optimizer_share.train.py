"""Share of the traced training steps' device time spent in the program's
``optimizer`` range (``optim/adamw.py``: the clip and the AdamW update),
in the stretch with the host's ranges: the stretch holds whole steps, and
the backward's kernels, which autograd launches from a thread of its own,
count in the total."""


def read(r):
    t = r.spans
    if t is None or not t.kernels or "optimizer" not in t.span_ms:
        return None
    return 100.0 * (t.span_ms["optimizer"] / 1e3) / t.kernel_s()

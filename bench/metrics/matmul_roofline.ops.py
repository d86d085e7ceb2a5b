"""The matmul kernel's share of its roofline over the traced passes: the
least time the card could take for each product (its FLOPs at the bf16
peak, or its A, B and C bytes at the HBM rate, whichever is longer) over
the device time of everything the passes launched."""


def read(r):
    t, w = r.trace, r.work
    passes = len(r.calls.get("passes") or [])
    if t is None or not passes or not t.kernels:
        return None
    least = passes * sum(w.bound(*w.matmul_work(m, n, k))[0] for m, n, k in r.calls["shapes"])
    return 100.0 * least / t.kernel_s()

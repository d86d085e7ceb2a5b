"""Share of the traced stretch with no kernel, copy or set running on the
device: 1 - (union of the device intervals) / (the stretch's length). The
reader of every ``device_idle.<kind>`` metric: a busy time over the
stretch reads below 0, so that a miscount shows."""


def read(r):
    t = r.trace
    if t is None or not t.window_s or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""The flash kernel's share of its roofline over the traced training steps:
each step launches it once per attention layer in the forward and once in
its remat recompute, at the batch's rows and length (causal); the least
time the card could take for those launches over their device time.
Nothing where the launches do not match that count."""


def is_flash(name):
    return "flash_fwd" in name


def read(r):
    t, c, w = r.trace, r.config, r.work
    steps = len(r.calls.get("steps") or [])
    if t is None or not steps or not t.kernels:
        return None
    launches = 2 * w.C.n_attention_layers(c) * steps
    if t.kernel_count(is_flash) != launches:
        return None
    least = launches * w.bound(*w.flash_work(r.calls["rows"], c["num_attention_heads"],
                                             c["num_key_value_heads"], r.calls["tokens"],
                                             w.C.head_dim(c), True))[0]
    return 100.0 * least / t.kernel_s(is_flash)

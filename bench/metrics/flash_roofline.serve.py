"""The flash kernel's share of its roofline over the traced stretch's
prefills: the least time the card could take for their attention (each
prompt's causal pairs at the bf16 peak, or its q, k, v and output bytes at
the HBM rate, whichever is longer) over the device time of the flash
kernel's launches. The device tracer may drop some records of a busy
stretch (a traced docqa run on an H100 kept 334 of its 11 prefills' 352
launches): the launches it kept are then counted at the prefills' mean
least time per launch. Nothing where there are no launches, or more than
one per attention layer per prefill."""


def is_flash(name):
    return "flash_fwd" in name


def read(r):
    t, c, w = r.trace, r.config, r.work
    prefills = r.calls.get("prefills") or []
    if t is None or not prefills or not t.kernels:
        return None
    layers = w.C.n_attention_layers(c)
    launches, due = t.kernel_count(is_flash), layers * len(prefills)
    if not launches or launches > due:
        return None
    least = sum(layers * w.bound(*w.flash_work(1, c["num_attention_heads"],
                                               c["num_key_value_heads"], s,
                                               w.C.head_dim(c), True))[0]
                for s in prefills)
    return 100.0 * least * launches / due / t.kernel_s(is_flash)

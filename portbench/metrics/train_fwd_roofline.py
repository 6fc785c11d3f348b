"""The training forward's (B4) share of its roofline: the frozen count's
least time for every step of the window over the card's time in the
kernel (`fused_nms_kernel`, its training instance)."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None:
        return None
    ms = counts.kernel_ms(ctx["summary"], "fused_nms_kernel")
    if ms <= 0.0:
        return None
    s = counts.shape_of(ctx["cfg"], "train")
    return 100.0 * counts.train_bound(s, ctx["local_batch"], False, s.T - 1)["bound_ms"] \
        * ctx["steps"] / ms

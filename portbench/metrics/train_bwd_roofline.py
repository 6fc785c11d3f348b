"""The training backward's (B5) share of its roofline: the frozen count's
least time for every step of the window over the card's time in its
kernels (`train_bwd_kernel` and the gradient sums' `reduce_partials`)."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None:
        return None
    ms = counts.kernel_ms(ctx["summary"], "train_bwd_kernel", "reduce_partials")
    if ms <= 0.0:
        return None
    s = counts.shape_of(ctx["cfg"], "train")
    return 100.0 * counts.train_bound(s, ctx["local_batch"], True, s.T - 1)["bound_ms"] \
        * ctx["steps"] / ms

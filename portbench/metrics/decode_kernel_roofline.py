"""The fused decode kernel's share of its roofline: the frozen count's
least time for every batch of the window (each word's own iterations to
its genie stop, as the reference found them on the point it checked), over
the card's time in the kernel (`fused_nms_kernel` instances)."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None or ctx.get("word_iters_per_word") is None:
        return None
    ms = counts.kernel_ms(ctx["summary"], "fused_nms_kernel")
    if ms <= 0.0:
        return None
    s, B = counts.shape_of(ctx["cfg"]), ctx["local_batch"]
    least = counts.decode_bound(s, B, word_iters=ctx["word_iters_per_word"] * B)["bound_ms"]
    return 100.0 * least * ctx["batches_per_rank"] / ms

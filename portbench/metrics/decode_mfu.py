"""The whole simulation step's share of the card's simple-f32 peak: the
frozen count's operations for every batch of the window (the decode at
each word's own iterations to its genie stop, as the reference found them
on the point it checked, and the channel sampler), over the window's
seconds times 33.5e12 per card."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None or ctx.get("word_iters_per_word") is None:
        return None
    s, B, n = counts.shape_of(ctx["cfg"]), ctx["local_batch"], ctx["batches_per_rank"]
    dec = counts.decode_bound(s, B, word_iters=ctx["word_iters_per_word"] * B)["ops"]
    smp = counts.sampler_bound(s.N * s.z, B, quantize=True)["ops"]
    return 100.0 * (dec + smp) * n / (ctx["window_s"] * counts.F32_SIMPLE_OPS_PER_S)

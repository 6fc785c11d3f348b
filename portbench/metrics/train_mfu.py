"""The whole train step's share of the card's simple-f32 peak: the frozen
count's operations of the training pair's forward (B4) and backward (B5)
and of the channel sampler for every step of the window, over the window's
seconds times 33.5e12."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None:
        return None
    s, B = counts.shape_of(ctx["cfg"], "train"), ctx["local_batch"]
    t0 = s.T - 1  # the soft-FER loss reads the last iteration only
    ops = (counts.train_bound(s, B, False, t0)["ops"] + counts.train_bound(s, B, True, t0)["ops"]
           + counts.sampler_bound(s.N * s.z, B, quantize=True)["ops"])
    return 100.0 * ops * ctx["steps"] / (ctx["window_s"] * counts.F32_SIMPLE_OPS_PER_S)

"""The channel sampler's card ms per batch: `randn` (PyTorch's normal
kernel), the LLR pass (`awgn_llr`) and the sigma fill."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None or not ctx["batches_per_rank"]:
        return None
    ms = counts.kernel_ms(ctx["summary"], "awgn_llr", "normal", "FillFunctor<float>")
    return ms / ctx["batches_per_rank"] if ms > 0.0 else None

"""Card ms of the NCCL all-reduce kernels per host read on rank 0 (one
all-reduce of a read's counters each)."""

from portbench import counts


def read(ctx):
    if ctx["summary"] is None or not ctx.get("reads"):
        return None
    ms = counts.kernel_ms(ctx["summary"], "nccl", "AllReduce")
    return ms / ctx["reads"] if ms > 0.0 else None

"""Host ms capturing the host read's CUDA graph (`ldpc.fer.capture`) per
point (`ldpc.fer.point`); 0 when no point captured."""

from portbench import spans


def read(ctx):
    return spans.ms_per("ldpc.fer.capture", "ldpc.fer.point")

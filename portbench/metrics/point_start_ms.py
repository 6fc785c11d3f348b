"""Host ms from a point's entry into `run_point` until its first host read
is enqueued (`ldpc.fer.start`: the resume, the rank's generator, sigma, a
capture and the first issue), per point (`ldpc.fer.point`)."""

from portbench import spans


def read(ctx):
    return spans.ms_per("ldpc.fer.start", "ldpc.fer.point")

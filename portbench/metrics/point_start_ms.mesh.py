"""As `point_start_ms`, on rank 0 of the mesh: host ms of `ldpc.fer.start`
per `ldpc.fer.point`."""

from portbench import spans


def read(ctx):
    return spans.ms_per("ldpc.fer.start", "ldpc.fer.point")

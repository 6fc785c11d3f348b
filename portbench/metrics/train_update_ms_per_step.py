"""Card ms of a train step's update (`ldpc.train.update`, timed by CUDA
events: the gradient mask, the mesh sum, Adam and the clip) per step."""

from portbench import spans


def read(ctx):
    return spans.ms_per("ldpc.train.update", "ldpc.train.update", clock="device_ms")

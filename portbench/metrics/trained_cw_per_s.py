"""Codewords through whole train steps in the window (sampling, the
training pair, the loss, Adam, the clip), over the window's seconds (host
clock, closed when the card has finished the last step)."""


def read(ctx):
    return ctx["words"] / ctx["window_s"]

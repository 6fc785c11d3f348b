"""Codewords the points of the window counted across every rank (the
pooled counters), over the window's seconds on rank 0's host clock."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"]

"""Codewords the points of the window counted, over the window's seconds
(host clock, from the first point's start to the last point's end)."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"]

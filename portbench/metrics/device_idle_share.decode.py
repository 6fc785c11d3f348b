"""Share of the traced window in which the card ran no kernel, copy or
fill: one minus the union of its activities (averaged over the cards of
the cell) over the window's seconds."""


def read(ctx):
    if ctx["summary"] is None:
        return None
    busy = ctx.get("busy_s", ctx["summary"]["device_busy_ms"] / 1e3)
    return 100.0 * (1.0 - busy / ctx["window_s"])

"""The port's in-memory span table, as the span metrics read it.

`ldpc_error_floor_tpu_torch.utils.profiling.snapshot()` holds every span
the program recorded while a profiler ran: in a `--trace 1` run the window
alone (set-up and warm-up run with no profiler, and the program records
nothing then), on a cell of several chips rank 0's window.  A program
without that table gives None, and so does every metric that reads it.
"""

from __future__ import annotations

from typing import Optional

from ldpc_error_floor_tpu_torch.utils import profiling


def table() -> Optional[dict]:
    """``{name: {"count", "host_ms", "device_ms"}}``, or None where the
    program keeps no span table."""
    snapshot = getattr(profiling, "snapshot", None)
    return None if snapshot is None else snapshot()


def ms_per(name: str, per: str, clock: str = "host_ms") -> Optional[float]:
    """The ms of span `name` on `clock` ("host_ms" or "device_ms") per span
    `per`; 0 where `per` was recorded and `name` never; None where `per`
    was never recorded or `name` has no time on that clock."""
    tab = table()
    if not tab or not tab.get(per, {}).get("count"):
        return None
    row = tab.get(name)
    if row is None:
        return 0.0
    if row[clock] is None:
        return None
    return row[clock] / tab[per]["count"]

"""Tracing and timing helpers (port of
`ldpc_error_floor_tpu/utils/profiling.py`).

* `trace(trace_dir)` profiles the enclosed block with `torch.profiler`: the
  host's PyTorch operations and, on the card, its kernels and copies; it
  writes one Chrome trace (``trace.json``) into `trace_dir`.  With no
  directory it does nothing, so call sites can wrap a phase
  unconditionally.  There is no environment switch: the caller passes the
  directory.
* `annotate(name)` names a host span in that trace
  (`torch.profiler.record_function`).
* `Timer` is the accumulating wall-clock timer the perf log uses.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the enclosed block into ``{trace_dir}/trace.json`` and yield
    the profiler (its `key_averages()` sum the block by operation and
    kernel); a no-op yielding None without `trace_dir`."""
    if not trace_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def annotate(name: str):
    """A named host span in the trace `trace` writes."""
    return torch.profiler.record_function(name)


class Timer:
    """Accumulating wall-clock phase timer (perf-log granularity)."""

    def __init__(self):
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None
        return False

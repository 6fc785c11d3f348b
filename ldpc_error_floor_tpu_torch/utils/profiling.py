"""Tracing helpers (port of `ldpc_error_floor_tpu/utils/profiling.py`).

* `trace(trace_dir)` profiles the enclosed block with `torch.profiler`: the
  host's PyTorch operations and, on the card, its kernels and copies; it
  writes one Chrome trace (``trace.json``) into `trace_dir`.  With no
  directory it does nothing, so call sites can wrap a phase
  unconditionally.  There is no environment switch: the caller passes the
  directory.
* `annotate(name, device=None)` is the port's one span.  While no
  `torch.profiler` is active it reads the profiler's flag and does nothing
  else: it opens no range and records nothing.  While one is active (under
  `trace`, or a profiler the caller started) it opens a
  `record_function(name)` range, which the profiler's Chrome trace holds on
  the clock of the card's kernels, and adds the span's count and
  host-clock seconds to an in-memory table keyed by name.  Given the
  `device` the enclosed work runs on, a CUDA device whose current stream
  is not capturing a graph, it also records a CUDA event on that stream at
  entry and at exit; the card's milliseconds between them join the table
  as the pairs complete.  Work on the CPU records no event, whatever cards
  the host has.
* `snapshot()` reads that table: ``{name: {"count", "host_ms",
  "device_ms"}}`` (``device_ms`` None for a span no event pair timed),
  waiting for pairs still on the card.  `reset()` empties it; `trace`
  does so on entry, so the table holds that block's spans.
* `add_counter(name, read, clear)` registers counters that the program
  keeps on the card and writes only while a profiler is active (`active()`;
  the early-stop kernel's lane-steps and words, `ops/fused_decoder.py`).
  `snapshot()` holds their values, ``{name: {key: int}}``, once one is not
  0, beside the spans; `reset()` sets them back to 0.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_NOTHING = contextlib.nullcontext()


class _Row:
    """One span name's totals, and its event pairs not yet folded in."""

    __slots__ = ("count", "host_s", "device_ms", "timed", "pending")

    def __init__(self):
        self.count, self.host_s = 0, 0.0
        self.device_ms, self.timed = 0.0, 0
        self.pending: collections.deque = collections.deque()

    def fold(self, wait: bool = False) -> None:
        """Add the card time of the completed pairs (all of them with
        `wait`), oldest first: one stream completes them in order."""
        while self.pending:
            start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.device_ms += start.elapsed_time(end)
            self.timed += 1
            self.pending.popleft()


_TABLE: Dict[str, _Row] = {}
_COUNTERS: Dict[str, Tuple[Callable[[], Dict[str, int]], Callable[[], None]]] = {}


def active() -> bool:
    """Whether a `torch.profiler` is active (all that a span reads without
    one)."""
    return _autograd_profiler._is_profiler_enabled


def add_counter(name: str, read: Callable[[], Dict[str, int]],
                clear: Callable[[], None]) -> None:
    """Let `snapshot()` hold the counters `read()` returns under `name`,
    and `reset()` call `clear()`."""
    _COUNTERS[name] = (read, clear)


class _Span:
    __slots__ = ("name", "range", "events", "t0")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.range = torch.profiler.record_function(name)
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                if not torch.cuda.is_current_stream_capturing():
                    self.events = (torch.cuda.current_stream(),
                                   torch.cuda.Event(enable_timing=True),
                                   torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.range.__enter__()
        if self.events is not None:
            self.events[1].record(self.events[0])
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[2].record(self.events[0])
        self.range.__exit__(*exc)
        row = _TABLE.get(self.name)
        if row is None:
            row = _TABLE[self.name] = _Row()
        row.count += 1
        row.host_s += host_s
        if self.events is not None:
            row.pending.append(self.events[1:])
            row.fold()
        return False


def annotate(name: str, device: Optional[torch.device] = None):
    """A named span: nothing while no profiler is active; else a range in
    the profiler's trace and a row of `snapshot()` (given the work's CUDA
    `device`, its card time too, between CUDA events on that device's
    current stream)."""
    if not active():
        return _NOTHING
    return _Span(name, device)


def snapshot() -> Dict[str, dict]:
    """Every span recorded since the last `reset`: its count, host-clock
    ms and card ms (None where no event pair timed it); and the values of
    each registered counter of which one is not 0."""
    out = {}
    for name, row in _TABLE.items():
        row.fold(wait=True)
        out[name] = {"count": row.count, "host_ms": row.host_s * 1e3,
                     "device_ms": row.device_ms if row.timed else None}
    for name, (read, _) in _COUNTERS.items():
        values = read()
        if any(values.values()):
            out[name] = values
    return out


def reset() -> None:
    """Empty the span table and set the registered counters to 0."""
    _TABLE.clear()
    for _, clear in _COUNTERS.values():
        clear()


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the enclosed block into ``{trace_dir}/trace.json`` and yield
    the profiler (its `key_averages()` sum the block by operation and
    kernel); the span table starts empty.  A no-op yielding None without
    `trace_dir`."""
    if not trace_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

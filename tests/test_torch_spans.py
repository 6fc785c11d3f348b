"""The port's spans (`utils.profiling.annotate`) in its host loops.

With no profiler active a span only reads the profiler's flag: a
`run_point` enters no `record_function` and leaves the span table empty.
Under `utils.profiling.trace` a `run_point` of three host reads records one
``ldpc.fer.point`` holding one ``ldpc.fer.start`` (which holds the first
issue), three ``ldpc.fer.issue`` and three ``ldpc.fer.wait`` spans, as
`snapshot()` counts them and as the Chrome trace nests them; an epoch of
one train step records each ``ldpc.train.*`` span once, none timed on a
card since the step's work is on the CPU; a harvest records a step and a
read per batch.  On the card: one capture per point, inside the point's
first issue, and a span timed by CUDA events reads the card's time.  The card's cases start no
profiler: they raise the profiler's flag alone and log the ranges the spans
open, since a profiler session leaves a later CUDA-only one in the same
process with no kernel events.  This file imports nothing of JAX, so the
card's cases run with ``--noconftest -m cuda``.
"""

import json

import pytest
import torch

from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, init_weights)
from ldpc_error_floor_tpu_torch.sim import FERSimulator, UncorHarvester
from ldpc_error_floor_tpu_torch.training.train import make_epoch_step, make_optimizer
from ldpc_error_floor_tpu_torch.utils import annotate, profiling, snapshot, trace

MACKAY = "MACKAY_N96_K48"
WMAN = "wman_N0576_R34_z24"
TRAIN_SPANS = ["ldpc.train.backward", "ldpc.train.forward", "ldpc.train.loss",
               "ldpc.train.sample", "ldpc.train.update"]


def _sim(device, batch=16, inner_steps=2, code_name=MACKAY):
    code = get_code(code_name)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(decoding_type=1), spec, graph=graph,
                     device=device)
    ch = AWGNChannel(code, decoding_type=1, device=device)
    return FERSimulator(dec, ch, batch=batch, inner_steps=inner_steps), \
        init_weights(spec, graph, device=device)


def _spans(trace_path):
    """(name, start, end) of every `record_function` range of the trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("ldpc.")]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_no_record_function_and_nothing_recorded(monkeypatch):
    sim, params = _sim("cpu")
    profiling.reset()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pt = sim.run_point(params, 2.0, torch.Generator().manual_seed(1),
                       max_frames=3 * 32, target_frame_errors=None)
    assert pt.frames == 96
    with annotate("ldpc.test", device=torch.device("cuda")):
        pass
    assert snapshot() == {}


def test_run_point_under_trace_records_nested_spans(tmp_path):
    sim, params = _sim("cpu")
    with trace(str(tmp_path)):
        pt = sim.run_point(params, 2.0, torch.Generator().manual_seed(1),
                           max_frames=3 * 32, target_frame_errors=None)
    assert pt.frames == 96  # three host reads
    snap = snapshot()
    counts = {k: v["count"] for k, v in snap.items()}
    assert counts == {"ldpc.fer.point": 1, "ldpc.fer.start": 1,
                      "ldpc.fer.issue": 3, "ldpc.fer.wait": 3}
    assert all(v["host_ms"] > 0 and v["device_ms"] is None for v in snap.values())
    assert snap["ldpc.fer.start"]["host_ms"] <= snap["ldpc.fer.point"]["host_ms"]
    spans = _spans(tmp_path / "trace.json")
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert {k: len(v) for k, v in by.items()} == counts
    (point,), (start,) = by["ldpc.fer.point"], by["ldpc.fer.start"]
    issues, waits = sorted(by["ldpc.fer.issue"], key=lambda s: s[1]), by["ldpc.fer.wait"]
    assert _within(start, point)
    assert all(_within(s, point) for s in issues + waits)
    # the first issue inside the start-up; the later ones and every wait after it
    assert _within(issues[0], start)
    assert all(s[1] >= start[2] for s in issues[1:] + waits)
    # spans of one level never overlap
    level = sorted(issues[1:] + waits, key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(level, level[1:]))


def test_trace_starts_an_empty_table_and_reset_empties_it(tmp_path):
    sim, params = _sim("cpu")
    for _ in range(2):
        with trace(str(tmp_path)):
            sim.run_point(params, 2.0, torch.Generator().manual_seed(1),
                          max_frames=32, target_frame_errors=None)
        assert snapshot()["ldpc.fer.point"]["count"] == 1
    profiling.reset()
    assert snapshot() == {}


def test_counters_join_the_snapshot_once_not_zero(monkeypatch):
    """A counter the program keeps on the card (`add_counter`: the early
    stop's lane-steps and words) is in `snapshot()` beside the spans once
    one of its values is not 0, and `reset()` sets it back to 0."""
    values = {"lane_steps": 0, "words": 0}
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    profiling.reset()
    profiling.add_counter("fused_nms_early_stop", lambda: dict(values),
                          lambda: values.update(lane_steps=0, words=0))
    assert snapshot() == {}
    values.update(lane_steps=28, words=10)
    with trace(None), annotate("ldpc.test"):
        pass
    assert snapshot() == {"fused_nms_early_stop": {"lane_steps": 28, "words": 10}}
    profiling.reset()
    assert values == {"lane_steps": 0, "words": 0} and snapshot() == {}


def test_epoch_of_one_step_records_each_train_span_once(tmp_path):
    code = get_code(MACKAY)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(app_t0=2), spec, graph=graph, device="cpu")
    ch = AWGNChannel(code, device="cpu")
    params = init_weights(spec, graph, device="cpu")
    optimizer = make_optimizer(params, 1e-3)
    B = 32
    epoch = make_epoch_step(dec, spec, 2, 0, 3, 0, n_steps=1,
                            labels=torch.zeros((code.N * code.z, B)), channel=ch,
                            sigmas=torch.full((B,), 0.8), static_etha=0.0)
    with trace(str(tmp_path)):
        loss = epoch(params, optimizer, torch.Generator().manual_seed(4), 0.0)
    assert torch.isfinite(loss)
    snap = snapshot()
    assert sorted(snap) == TRAIN_SPANS
    assert all(v["count"] == 1 and v["host_ms"] > 0 for v in snap.values())
    # work on the CPU records no CUDA event, whether or not the host has a card
    assert all(v["device_ms"] is None for v in snap.values())


def test_harvest_records_a_step_and_a_read_per_batch(tmp_path):
    code = get_code(MACKAY)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(), spec, graph=graph, device="cpu")
    h = UncorHarvester(dec, AWGNChannel(code, device="cpu"), batch=32, cap=32)
    with trace(str(tmp_path)):
        h.collect(init_weights(spec, graph, device="cpu"), 1.0,
                  torch.Generator().manual_seed(2), target_words=10 ** 6,
                  max_frames=3 * 32)
    snap = snapshot()
    assert snap["ldpc.harvest.step"]["count"] == snap["ldpc.harvest.read"]["count"] == 3
    assert "ldpc.harvest.ckpt" not in snap


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


class _RangeLog:
    """Stands in for `record_function`: logs each range's entry and exit."""
    log = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.log.append(("enter", self.name))

    def __exit__(self, *exc):
        self.log.append(("exit", self.name))


@pytest.fixture
def spans_on(monkeypatch):
    """The spans record as under a profiler, with no profiler started."""
    profiling.reset()
    _RangeLog.log = []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.profiler, "record_function", _RangeLog)
    yield _RangeLog
    profiling.reset()


@pytest.mark.cuda
def test_one_capture_per_point_on_card(spans_on):
    dev = _cuda()
    sim, params = _sim(dev, batch=1024, inner_steps=2, code_name=WMAN)
    for seed in (1, 2):  # a generator of its own per point, as a curve draws
        sim.run_point(params, 3.0, torch.Generator(device=dev).manual_seed(seed),
                      max_frames=3 * 2048, target_frame_errors=None)
    snap = snapshot()
    assert snap["ldpc.fer.point"]["count"] == snap["ldpc.fer.capture"]["count"] == 2
    assert snap["ldpc.fer.issue"]["count"] == snap["ldpc.fer.wait"]["count"] == 6
    # each capture inside the first issue of a point, in its start-up
    stack = []
    for what, name in spans_on.log:
        if what == "enter":
            if name == "ldpc.fer.capture":
                assert stack[-2:] == ["ldpc.fer.start", "ldpc.fer.issue"]
            stack.append(name)
        else:
            assert stack.pop() == name
    assert not stack


@pytest.mark.cuda
def test_device_span_reads_the_card_time(spans_on):
    dev = _cuda()
    a = torch.randn((2048, 2048), device=dev)
    for _ in range(3):
        with annotate("ldpc.test.matmul", device=dev):
            for _ in range(10):
                a = torch.tanh(a @ a)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        with annotate("ldpc.test.captured", device=dev):
            b = a + 1
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    snap = snapshot()
    row = snap["ldpc.test.matmul"]
    assert row["count"] == 3 and row["device_ms"] > 0.0
    # no events while a stream captures: counted on the host alone
    assert snap["ldpc.test.captured"]["count"] == 1
    assert snap["ldpc.test.captured"]["device_ms"] is None
    del b

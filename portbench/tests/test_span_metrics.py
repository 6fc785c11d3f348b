"""The span metrics on a synthetic span table: each reads the ms the table
gives, and None where the table holds no point or step, or where the
program keeps no table."""

import pytest

from ldpc_error_floor_tpu_torch.utils import profiling
from portbench import harness

ROW = lambda count, host_ms, device_ms=None: {"count": count, "host_ms": host_ms,
                                              "device_ms": device_ms}
DECODE = {"ldpc.fer.point": ROW(4, 4000.0), "ldpc.fer.start": ROW(4, 100.0),
          "ldpc.fer.capture": ROW(4, 60.0), "ldpc.fer.issue": ROW(512, 85.6),
          "ldpc.fer.wait": ROW(508, 3800.0)}
TRAIN = {"ldpc.train.forward": ROW(10, 1.0, 80.0),
         "ldpc.train.update": ROW(10, 5.0, 3.0)}
EXPECTED = [("point_start_ms", DECODE, 25.0), ("point_start_ms.mesh", DECODE, 25.0),
            ("capture_ms_per_point", DECODE, 15.0), ("host_issue_ms_per_read", DECODE, 0.05),
            ("train_update_ms_per_step", TRAIN, 0.3)]


@pytest.mark.parametrize("name,table,ms", EXPECTED, ids=[e[0] for e in EXPECTED])
def test_reader_returns_the_tables_ms(monkeypatch, name, table, ms):
    monkeypatch.setattr(profiling, "snapshot", lambda: table)
    assert harness.metric_reader(name)({}) == pytest.approx(ms)


@pytest.mark.parametrize("name", [e[0] for e in EXPECTED])
def test_reader_returns_none_without_a_point_or_step(monkeypatch, name):
    other = TRAIN if name.startswith("point") or "issue" in name or "capture" in name else DECODE
    for table in ({}, other):
        monkeypatch.setattr(profiling, "snapshot", lambda: table)
        assert harness.metric_reader(name)({}) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without the table
    assert harness.metric_reader(name)({}) is None


def test_a_point_that_captured_nothing_reads_zero(monkeypatch):
    table = {k: v for k, v in DECODE.items() if k != "ldpc.fer.capture"}
    monkeypatch.setattr(profiling, "snapshot", lambda: table)
    assert harness.metric_reader("capture_ms_per_point")({}) == 0.0
    # the issue's self time is then all of its time
    assert harness.metric_reader("host_issue_ms_per_read")({}) == pytest.approx(85.6 / 512)


def test_update_without_card_time_reads_none(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"ldpc.train.update": ROW(10, 5.0)})
    assert harness.metric_reader("train_update_ms_per_step")({}) is None


def test_every_span_metric_has_its_entry():
    bench = harness.load_bench()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name, _, _ in EXPECTED:
        assert names[name]["unit"] == "ms" and names[name]["workloads"]

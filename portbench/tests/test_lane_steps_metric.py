"""`decode_lane_steps_per_word` on a synthetic snapshot: the early stop's
lane-steps over its words from the engagement pair `snapshot()` holds, and
None without the pair (a program that keeps none), without words, or
without the table."""

import pytest

from ldpc_error_floor_tpu_torch.utils import profiling
from portbench import harness

POINT = {"ldpc.fer.point": {"count": 4, "host_ms": 4000.0, "device_ms": None}}


def test_lane_steps_per_word_reads_the_engagement_pair(monkeypatch):
    read = harness.metric_reader("decode_lane_steps_per_word")
    pair = {"fused_nms_early_stop": {"lane_steps": 2_700_000, "words": 1_000_000}}
    monkeypatch.setattr(profiling, "snapshot", lambda: {**POINT, **pair})
    assert read({}) == pytest.approx(2.7)


@pytest.mark.parametrize("table", [{}, POINT, {"fused_nms_early_stop":
                                               {"lane_steps": 0, "words": 0}}],
                         ids=["empty", "no_pair", "no_words"])
def test_lane_steps_per_word_reads_none_without_words(monkeypatch, table):
    monkeypatch.setattr(profiling, "snapshot", lambda: table)
    assert harness.metric_reader("decode_lane_steps_per_word")({}) is None


def test_lane_steps_per_word_reads_none_without_the_table(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    assert harness.metric_reader("decode_lane_steps_per_word")({}) is None


def test_lane_steps_per_word_has_its_entry():
    entry = {m["name"]: m for m in harness.load_bench()["per_layer"]}["decode_lane_steps_per_word"]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "steps", "lower", "device_trace", "decoded_cw_per_s")
    assert entry["workloads"] == ["wman-floor", "nr5g-floor"]

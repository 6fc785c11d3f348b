"""The frozen counts at the shapes of PERF.md's kernel table, and the
trace summary on a small synthetic trace."""

import json

import pytest

from portbench import counts, harness


def _shape(cfg_name, part):
    return counts.shape_of(harness.config(harness.load_bench(), cfg_name), part)


def test_fixed_t_bounds_match_the_kernel_table():
    base20 = _shape("wman576-base20", "decoder")
    train = _shape("wman576-base20", "train")
    assert counts.decode_bound(base20, 65536)["bound_ms"] == pytest.approx(1.720, abs=5e-4)
    assert counts.train_bound(train, 32768, False, t0=19)["bound_ms"] == pytest.approx(2.036, abs=5e-4)
    assert counts.train_bound(train, 32768, True, t0=19)["bound_ms"] == pytest.approx(2.058, abs=5e-4)
    assert counts.sampler_bound(576, 65536, quantize=True)["bound_ms"] == pytest.approx(0.090, abs=5e-4)


def test_early_stop_counts_each_words_own_iterations():
    s = _shape("wman576-base20", "decoder")
    full = counts.decode_bound(s, 1024)
    own = counts.decode_bound(s, 1024, word_iters=1024 * 2)
    assert own["ops"] == pytest.approx(full["ops"] * 2 / s.T)


def test_trace_summary_unions_activity_and_names_gaps(tmp_path):
    events = [
        {"cat": "user_annotation", "name": "portbench.point", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "k2", "ts": 20, "dur": 20},   # overlaps k1
        {"cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = counts.trace_summary(str(path))
    assert s["kernel_ms"] == {"k1": 0.02, "k2": 0.02}
    assert s["device_busy_ms"] == pytest.approx(0.04)
    assert s["device_span_ms"] == pytest.approx(0.06)
    assert s["idle_gaps"] == [("portbench.point", pytest.approx(20e-6))]

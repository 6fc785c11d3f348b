"""The benchmark's files, names and imports, on the CPU."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


from portbench import harness

ROOT = harness.REPO
BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_every_entry_resolves_to_its_file():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = harness.config(BENCH, c["name"])
        for rel in (cfg["code"]["file"], cfg["weights"]):
            assert (ROOT / rel).is_file()
    for w in BENCH["workloads"]:
        traffic = harness.traffic(w["traffic"])
        assert harness.kind_module(traffic["kind"]).window
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    shutil.copy(copy / "portbench/traffic/deep-floor-5.5dB.json",
                copy / "portbench/traffic/deep-floor-6.0dB.json")
    (copy / "portbench/metrics/points_per_window.py").write_text(
        "def read(ctx):\n    return ctx['attempted']\n")
    bench["workloads"].append({"name": "wman-floor-6db", "config": "wman576-base20",
                               "traffic": "deep-floor-6.0dB", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "points_per_window", "unit": "points",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "decoded_cw_per_s",
                               "workloads": ["wman-floor-6db"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = harness.load_bench(copy)
    assert harness.traffic("deep-floor-6.0dB", copy)["snr_db"] == 5.5
    names = [m["name"] for m in harness.metrics_of(bench, "wman-floor-6db", True)]
    assert names == ["points_per_window"]
    got = harness.read_metrics(bench, "wman-floor-6db", True, {"attempted": 7}, copy)
    assert got == {"points_per_window": {"value": 7, "unit": "points"}}


def test_names_units_and_lines_use_the_allowed_characters():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        names.append(w["name"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and ONE_LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "layer" in m:
            assert ONE_LINE.match(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len({n for n in names}) == len(names)
    assert all(ONE_LINE.match(w) for w in BENCH["command"])


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_that_imports_nothing_of_the_program():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = set(_top_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "ldpc_error_floor_tpu"}, path
        if "reference" in path.parts:
            assert "ldpc_error_floor_tpu_torch" not in tops, path


def test_run_fails_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"), "--workload",
                          "wman-floor", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr

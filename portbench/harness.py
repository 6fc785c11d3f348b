"""Finding the benchmark's files by the names in `BENCHMARK.json`.

A configuration is the JSON file its entry names; a traffic mix is
`portbench/traffic/<traffic>.json`, read by the general runner of its
`kind` (`portbench/drive/<kind>.py`); a metric is read by
`portbench/metrics/<name>.py`, whose `read(ctx)` returns the value or None
when the run holds nothing to read.  Adding a cell, a mix or a metric is
adding its file and its entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_error_floor_tpu")  # top-level names, whole


def path(rel: str) -> Path:
    """A path that the benchmark's files give relative to the checkout."""
    return REPO / rel


def load_bench(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = REPO) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str, root: Path = REPO) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad traffic name {name!r}")
    return root / "portbench" / "traffic" / f"{name}.json"


def traffic(name: str, root: Path = REPO) -> dict:
    with open(traffic_file(name, root)) as f:
        return json.load(f)


def kind_module(kind: str):
    """The general runner of a traffic kind."""
    if not re.match(r"^[a-z_]+$", kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"portbench.drive.{kind}")


def metric_file(name: str, root: Path = REPO) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return root / "portbench" / "metrics" / f"{name}.py"


def metric_reader(name: str, root: Path = REPO) -> Callable[[dict], Optional[float]]:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  metric_file(name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    the trace its per-layer ones (those that list it, or list no cells)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def read_metrics(bench: dict, cell_name: str, trace: bool, ctx: dict,
                 root: Path = REPO) -> Dict[str, dict]:
    out = {}
    for m in metrics_of(bench, cell_name, trace):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """The modules of JAX or the JAX package that this process holds."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})

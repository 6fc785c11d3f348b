"""The mesh cell's path in four gloo processes on the CPU: the points'
pooled counters against the reference's four rank generators, and the
exchange between the ranks left out."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

RANK = Path(__file__).resolve().parent / "mesh_rank.py"


def _mesh_cell():
    return next(w["name"] for w in harness.load_bench()["workloads"] if w["chips"] > 1)


def _run(fault: str) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cell = _mesh_cell()
    procs = [subprocess.Popen([sys.executable, str(RANK), str(r), str(port), cell, fault],
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0, 0]
    return json.loads(outs[0].strip().splitlines()[-1])


@pytest.mark.parametrize("fault,correct", [("none", True), ("no_exchange", False)])
def test_mesh_cell_on_four_gloo_ranks(fault, correct):
    line = _run(fault)
    assert line["correct"] is correct
    assert line["device"]["count"] == 4

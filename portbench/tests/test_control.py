"""The control: the program on its own lower-precision path (QMS with 4-bit
messages, the grid below the configurations' 5-bit one) must come out not
correct against the reference at 5 bits.  On the CPU at a small size; on
the card (marked `cuda`) at each cell's own size, on three seeds, printing
the readings that set the limits."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, run

CELLS = ("wman-floor", "nr5g-floor", "wman-train")
MESH_CONTROL = Path(__file__).resolve().parent / "mesh_control.py"


def lower_precision(cfg: dict) -> dict:
    ctl = copy.deepcopy(cfg)
    for part in ("decoder", "train"):
        if part in ctl:
            ctl[part]["q_bit"] = 4
    return ctl


def _control(cell_name, seed, seconds, device, traffic=None):
    bench = harness.load_bench()
    cell = harness.cell(bench, cell_name)
    cfg = harness.config(bench, cell["config"])
    return run.run_cell(bench, cell, seed, seconds, False, device=device, traffic=traffic,
                        program_cfg=lower_precision(cfg))


@pytest.mark.parametrize("cell_name,snr", [("wman-floor", 3.0), ("nr5g-floor", 2.0)])
def test_control_is_not_correct_on_the_cpu(cell_name, snr):
    traffic = harness.traffic(harness.cell(harness.load_bench(), cell_name)["traffic"])
    traffic.update(batch_per_rank=256, inner_steps=1, frames_per_point=256, snr_db=snr)
    line = _control(cell_name, 5, 0.1, "cpu", traffic)
    assert line["correct"] is False
    assert line["checks"]["genie_gap"]["value"] > line["checks"]["genie_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    readings = []
    for seed in (2147480001, 2147480002, 2147480003):
        line = _control(cell_name, seed, 1.0, "cuda")
        readings.append({k: c["value"] for k, c in line["checks"].items()})
        assert line["correct"] is False
    print(json.dumps({"control": cell_name, "readings": readings}))


@pytest.mark.cuda
def test_mesh_control_is_not_correct_on_the_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs")
    bench = harness.load_bench()
    for cell in (w for w in bench["workloads"] if w["chips"] > 1):
        if torch.cuda.device_count() < cell["chips"]:
            pytest.skip(f"{cell['name']} needs {cell['chips']} cards")
        readings = []
        for seed in (2147480021, 2147480022, 2147480023):
            out = subprocess.run([sys.executable, str(MESH_CONTROL), "--workload", cell["name"],
                                  "--seed", str(seed), "--seconds", "1"],
                                 capture_output=True, text=True, timeout=600, check=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            readings.append({k: c["value"] for k, c in line["checks"].items()})
            assert line["correct"] is False
        print(json.dumps({"control": cell["name"], "readings": readings}))


def test_train_control_is_not_correct_on_the_cpu():
    traffic = harness.traffic(harness.cell(harness.load_bench(), "wman-train")["traffic"])
    traffic.update(batch=256)
    line = _control("wman-train", 5, 0.1, "cpu", traffic)
    assert line["correct"] is False

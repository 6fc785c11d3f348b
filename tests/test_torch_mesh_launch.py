"""The launcher of `--mesh` (`parallel/launch.py`) on the CPU, over gloo.

JAX's `simulate --mesh` and `train --mesh --mesh-devices N` spread over
every device of the process (`tests/test_cli.py` forces 8 virtual ones);
the port starts one rank process per card.  Here `spawn_ranks` runs W = 2
gloo ranks in the role of those devices:

* `simulate` (genie stop at K = 2 over two SNRs; syndrome stop) prints the
  JSON lines, `seconds` and `frames_per_sec` aside, of two ranks started by
  hand with the coordinator flags;
* `train` on a config cut to a few steps prints the lines and writes files
  byte-equal to those of two ranks started by hand (the perf log's running
  times aside);
* a failing rank ends the command within seconds with its exit code and no
  rank left alive: every rank raising (a batch that does not divide by W),
  or rank 1 dying before it joins while rank 0 waits for it at the
  rendezvous;
* more ranks than devices raise JAX's ``need N devices, have M`` before
  anything starts; the CPU counts one device; on a card the CLI's `--mesh`
  starts one rank per card (a card count faked here);
* two NCCL ranks on one card raise on every rank (the coordinator's store
  in this process).
"""

import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import ldpc_error_floor_tpu_torch.parallel as parallel  # noqa: E402
from ldpc_error_floor_tpu_torch import cli  # noqa: E402
from ldpc_error_floor_tpu_torch.parallel import spawn_ranks  # noqa: E402
from ldpc_error_floor_tpu_torch.parallel.mesh import _one_rank_per_card  # noqa: E402
from ldpc_error_floor_tpu_torch.pipelines import ExperimentConfig  # noqa: E402

WMAN = "wman_N0576_R34_z24"
TIMEOUT_S = 120
FAIL_WITHIN_S = 30  # far inside a collective's timeout of 600 s
SIM = ["simulate", "--code", WMAN, "--device", "cpu", "--iters", "3", "--batch", "32",
       "--max-frames", "64", "--mesh"]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Each rank process takes one core (the tests run beside others)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _by_hand(argv, world=2) -> str:
    """Rank 0's standard output of `world` ranks started by hand, each with
    the coordinator flags."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ldpc_error_floor_tpu_torch.cli", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id", str(r),
         *argv], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs[0][0]


def _points(out: str):
    return [{k: v for k, v in json.loads(s).items() if k not in ("seconds", "frames_per_sec")}
            for s in out.splitlines()]


@pytest.fixture
def recorded(monkeypatch):
    """Every process `spawn_ranks` starts."""
    made = []

    class Recorded(subprocess.Popen):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(subprocess, "Popen", Recorded)
    return made


@pytest.mark.parametrize("extra,n_points", [(["--snrs", "2.0", "2.5", "--inner-steps", "2"], 2),
                                            (["--snrs", "2.0", "--stop", "syndrome"], 1)],
                         ids=["genie", "syndrome"])
def test_spawn_ranks_simulate_equals_ranks_started_by_hand(extra, n_points, capsys, recorded):
    assert spawn_ranks(SIM + extra, 2, "cpu") == 0
    got = _points(capsys.readouterr().out)
    assert len(recorded) == 2 and all(p.returncode == 0 for p in recorded)
    want = _points(_by_hand(SIM + extra))
    assert got == want and len(got) == n_points
    assert all(pt["frames"] == 64 for pt in got)


def test_spawn_ranks_train_writes_the_files_of_ranks_started_by_hand(tmp_path, capsys):
    files = []
    for label in ("launched", "by_hand"):
        cfg = ExperimentConfig(
            code="MACKAY_N96_K48", sharing=(3, 0, 3), decoding_type=1, iters_max=2,
            fixed_iter=0, iter_step=2, sampling_type=0, loss_type=0, opt_metric=2,
            etha_start=0.0, learn_rate_start=1e-2, batch_size=64, training_num=192,
            epochs=2, valid_num=128, snrs=[2.0, 3.0], seed=5,
            out_dir=str(tmp_path / label))
        path = str(tmp_path / f"{label}.json")
        cfg.to_json(path)
        argv = ["train", "--config", path, "--mesh", "--mesh-devices", "2", "--device", "cpu"]
        if label == "launched":
            assert spawn_ranks(argv, 2, "cpu") == 0
            out = capsys.readouterr().out
        else:
            out = _by_hand(argv)
        assert out.splitlines()[-1].startswith("done; best metric")
        # the perf log's running times are the run's own
        got = {"stdout": [ln for ln in out.encode().splitlines()
                          if not ln.startswith(b"Running time")]}
        for name in sorted(os.listdir(cfg.out_dir)):
            with open(os.path.join(cfg.out_dir, name), "rb") as f:
                got[name] = [ln for ln in f.read().splitlines()
                             if not ln.startswith(b"Running time")]
        files.append(got)
    assert files[0] == files[1]
    assert any("Opt_Weight_End2" in name for name in files[0])


SITE_FAIL = """import os, sys, time
if sys.argv[sys.argv.index("--process-id") + 1] == "1":
    time.sleep(5)  # rank 0 is at the rendezvous by then
    os._exit(3)
"""


@pytest.mark.parametrize("how", ["every_rank_raises", "rank_1_dies_before_joining"])
def test_a_failing_rank_ends_the_command(how, tmp_path, monkeypatch, recorded):
    argv = SIM + ["--snrs", "2.0"]
    if how == "every_rank_raises":
        argv[argv.index("--batch") + 1] = "33"
    else:
        # rank 0 waits at the rendezvous for a rank that never comes
        (tmp_path / "sitecustomize.py").write_text(SITE_FAIL)
        monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    t0 = time.perf_counter()
    rc = spawn_ranks(argv, 2, "cpu")
    assert time.perf_counter() - t0 < FAIL_WITHIN_S
    assert rc == (1 if how == "every_rank_raises" else 3)
    assert len(recorded) == 2 and all(p.returncode is not None for p in recorded)


def test_more_ranks_than_devices_raise_before_any_spawn(tmp_path, monkeypatch, recorded):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        spawn_ranks(SIM + ["--snrs", "2.0"], 2, "cuda")
    # the CPU counts one device, as JAX counts a CPU host
    assert not dist.is_initialized()
    cfg = str(tmp_path / "base.json")
    cli.main(["init-config", "--out", cfg])
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        cli.main(["train", "--config", cfg, "--mesh", "--mesh-devices", "2",
                  "--device", "cpu"])
    assert recorded == [] and not dist.is_initialized()


def test_cli_mesh_starts_a_rank_per_card(tmp_path, monkeypatch, recorded):
    """On a card `--mesh` without a coordinator goes through the launcher:
    a rank per card, or the first N; more than the host has raise."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(parallel, "spawn_ranks",
                        lambda argv, world, device: calls.append((argv, world, device)) or 5)
    sim = ["simulate", "--code", WMAN, "--snrs", "4.0", "--mesh"]
    cfg = str(tmp_path / "base.json")
    train = ["train", "--config", cfg, "--mesh"]
    assert cli.main(sim) == 5
    assert cli.main(train + ["--mesh-devices", "2"]) == 5
    assert cli.main(train) == 5
    assert calls == [(sim, 4, "cuda"), (train + ["--mesh-devices", "2"], 2, "cuda"),
                     (train, 4, "cuda")]
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        cli.main(train + ["--mesh-devices", "8"])
    assert len(calls) == 3 and recorded == []


def test_two_nccl_ranks_on_one_card_raise():
    host = socket.gethostname()
    store = dist.HashStore()
    store.set("card/1", f"{host} cuda:1")
    _one_rank_per_card(store, torch.device("cuda", 0), 0, 2)  # two cards: no raise
    store = dist.HashStore()
    store.set("card/1", f"{host} cuda:0")
    with pytest.raises(ValueError, match="ranks 0 and 1 of 2 are both on .* cuda:0"):
        _one_rank_per_card(store, torch.device("cuda", 0), 0, 2)

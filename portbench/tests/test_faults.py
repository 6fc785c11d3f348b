"""A run with the timed path broken underneath must come out not correct:
each fault a decode cell can have, planted in the port's step on the CPU
at a small size, with the run's look for a card skipped."""

import pytest
import torch

from portbench import harness, run


def _run(cell_name, snr):
    bench = harness.load_bench()
    cell = harness.cell(bench, cell_name)
    traffic = harness.traffic(cell["traffic"])
    traffic.update(batch_per_rank=256, inner_steps=2, frames_per_point=512, snr_db=snr)
    return run.run_cell(bench, cell, 3, 0.1, False, device="cpu", traffic=traffic)


def _half_batch(original):
    """Half of the batch left out, the counters scaled from the rest."""
    def step(self, params, generator, sigma):
        full = self.local_batch
        self.local_batch = full // 2
        try:
            return original(self, params, generator, sigma) * 2
        finally:
            self.local_batch = full
    return step


def _answer_altered(original):
    """One more frame counted wrong at every iteration than decoded."""
    def step(self, params, generator, sigma):
        return original(self, params, generator, sigma) + torch.tensor([0, 0, 1])
    return step


@pytest.mark.parametrize("cell_name,snr", [("wman-floor", 3.0), ("nr5g-floor", 2.0)])
def test_sound_run_is_correct(cell_name, snr):
    assert _run(cell_name, snr)["correct"] is True


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered])
@pytest.mark.parametrize("cell_name,snr", [("wman-floor", 3.0), ("nr5g-floor", 2.0)])
def test_fault_is_not_correct(monkeypatch, fault, cell_name, snr):
    from ldpc_error_floor_tpu_torch.sim.fer import FERSimulator
    monkeypatch.setattr(FERSimulator, "_local_step", fault(FERSimulator._local_step))
    line = _run(cell_name, snr)
    assert line["correct"] is False
    assert line["failed"] == 1


def _run_train():
    bench = harness.load_bench()
    cell = harness.cell(bench, "wman-train")
    traffic = harness.traffic(cell["traffic"])
    traffic.update(batch=256)
    return run.run_cell(bench, cell, 3, 0.1, False, device="cpu", traffic=traffic)


def _state_unchanged(original):
    """A step that returns its state unchanged: Adam never steps."""
    def step(self, params, optimizer, llr, labels, etha):
        class Still:
            state = optimizer.state

            def step(self):
                pass
        return original(self, params, Still(), llr, labels, etha)
    return step


def _half_train_batch(original):
    """Half of the batch left out, the loss the mean over the rest."""
    def step(self, params, optimizer, llr, labels, etha):
        half = llr.shape[1] // 2
        return original(self, params, optimizer, llr[:, :half].contiguous(),
                        labels[:, :half], etha)
    return step


def test_sound_train_run_is_correct():
    assert _run_train()["correct"] is True


@pytest.mark.parametrize("fault", [_state_unchanged, _half_train_batch])
def test_train_fault_is_not_correct(monkeypatch, fault):
    from ldpc_error_floor_tpu_torch.training.train import TrainStep
    monkeypatch.setattr(TrainStep, "__call__", fault(TrainStep.__call__))
    line = _run_train()
    assert line["correct"] is False


@pytest.mark.cuda
def test_half_train_batch_on_the_card(monkeypatch):
    """The half-batch fault at the training cell's own size, on three seeds:
    the readings that bound the training limits from above."""
    import json
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ldpc_error_floor_tpu_torch.training.train import TrainStep
    monkeypatch.setattr(TrainStep, "__call__", _half_train_batch(TrainStep.__call__))
    bench = harness.load_bench()
    cell = harness.cell(bench, "wman-train")
    readings = []
    for seed in (2147480011, 2147480012, 2147480013):
        line = run.run_cell(bench, cell, seed, 1.0, False, device="cuda")
        readings.append({k: c["value"] for k, c in line["checks"].items()})
        assert line["correct"] is False
    print(json.dumps({"fault": "half_train_batch", "readings": readings}))

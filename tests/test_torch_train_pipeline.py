"""The port's training pipeline on the CPU (plain versions), at a tiny size
on the MacKay code: a base block (QMS, and neural BP), then a post block on
harvested words with the base rows frozen, and a killed-and-resumed run.

Checks: the weight files are the shared text format (the JAX package reads
them to the same values); epoch 0 evaluates only; the frozen prefix rows are
bit-unchanged after the post block and the post rows moved; the post block
reads the Uncor files the port's `append_uncor_file` wrote; a run stopped
after epoch 1 and resumed from its checkpoint ends with parameters and
weight file identical to an uninterrupted run.
"""

import json
import os

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.models import load_params as jax_load_params
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import get_code
from ldpc_error_floor_tpu_torch.io import (append_uncor_file, read_uncor_file,
                                         read_weight_file)
from ldpc_error_floor_tpu_torch.models import params_to_numpy
from ldpc_error_floor_tpu_torch.pipelines import (ExperimentConfig,
                                                  run_training,
                                                  split_uncor_dataset)

torch.set_num_threads(1)

MACKAY = "MACKAY_N96_K48"


def _base_cfg(out_dir, **kw):
    args = dict(code=MACKAY, sharing=(3, 3, 3), decoding_type=2,
                iters_max=4, fixed_iter=0, iter_step=4, loss_type=2,
                etha_start=0.0, learn_rate_start=1e-2, batch_size=32,
                training_num=96, epochs=2, valid_num=64, snrs=[2.0, 3.0],
                seed=3, out_dir=str(out_dir), out_prefix="T_MACKAY")
    args.update(kw)
    return ExperimentConfig(**args)


@pytest.fixture(scope="module")
def base_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_train") / "Weights"
    cfg = _base_cfg(out)
    return cfg, run_training(cfg, verbose=False, device="cpu")


def test_base_block_writes_shared_weight_files(base_run):
    cfg, res = base_run
    pre = os.path.join(cfg.out_dir, cfg.out_prefix)
    for suffix in ("_Weight_End4.txt", "_Opt_Weight_End4.txt", "_Performance.txt"):
        assert os.path.exists(pre + suffix)
    assert len(res.history) == 3 and res.history[0]["train_loss"] == 0.0
    assert res.launches == {}  # the CPU runs the plain versions
    assert all(h["train_loss"] > 0.0 for h in res.history[1:])
    # the JAX package reads the port's file to the port's final weights
    jspec = JaxSpec(sharing=(3, 3, 3), n_iters=4)
    jp = jax_load_params(jspec, JaxGraph(jax_get_code(MACKAY)),
                         pre + "_Weight_End4.txt")
    for k, v in params_to_numpy(res.params).items():
        np.testing.assert_array_equal(np.asarray(jp[k]), v)
    assert not np.allclose(params_to_numpy(res.params)["cn"], 1.0)
    log = open(pre + "_Performance.txt").read()
    assert log.count("Valid_Result") == 3 and "epoch: [2/2]" in log


def test_sp_base_block_trains_neural_bp(tmp_path):
    """Neural BP (decoding type 0, the card's B4-SP/B5-SP) through the same
    pipeline: the weight files appear, the JAX package reads them to the
    port's final weights, and the weights moved."""
    cfg = _base_cfg(tmp_path / "Weights", decoding_type=0, sharing=(3, 0, 3),
                    iters_max=3, iter_step=3, batch_size=32, training_num=64,
                    valid_num=32)
    res = run_training(cfg, verbose=False, device="cpu")
    pre = os.path.join(cfg.out_dir, cfg.out_prefix)
    for suffix in ("_Weight_End3.txt", "_Opt_Weight_End3.txt", "_Performance.txt"):
        assert os.path.exists(pre + suffix)
    assert res.launches == {} and len(res.history) == 3
    assert all(h["train_loss"] > 0.0 for h in res.history[1:])
    jp = jax_load_params(JaxSpec(sharing=(3, 0, 3), n_iters=3),
                         JaxGraph(jax_get_code(MACKAY)), pre + "_Weight_End3.txt")
    p = params_to_numpy(res.params)
    for k in ("cn", "vn"):
        np.testing.assert_array_equal(np.asarray(jp[k]), p[k])
        assert not np.allclose(p[k], 1.0)


def test_post_block_on_uncor_words_keeps_prefix(base_run, tmp_path):
    cfg, _ = base_run
    code = get_code(MACKAY)
    gen = torch.Generator().manual_seed(11)
    ch = AWGNChannel(code, device="cpu")
    llr = ch.sample(gen, torch.full((40,), float(code.snr_sigmas([1.0])[0])))
    uncor = str(tmp_path / "Uncor.txt")
    append_uncor_file(uncor, llr.T.numpy())
    in_dir = str(tmp_path / "Inputs")
    split_uncor_dataset(uncor, MACKAY, in_dir, 24, 8, 8)
    post = _base_cfg(cfg.out_dir, sampling_type=1, iters_max=6, fixed_iter=4,
                     iter_step=2, batch_size=8, training_num=24, epochs=1,
                     valid_num=8, test_flag=1, test_num=8, input_dir=in_dir)
    res = run_training(post, verbose=False, device="cpu")
    pre = os.path.join(cfg.out_dir, cfg.out_prefix)
    _, base_blocks = read_weight_file(pre + "_Opt_Weight_End4.txt")
    _, post_blocks = read_weight_file(pre + "_Opt_Weight_End6.txt")
    p = params_to_numpy(res.params)
    for k in ("cn", "ucn", "vn"):
        np.testing.assert_array_equal(p[k][:4], np.stack(base_blocks[k]))
        np.testing.assert_array_equal(np.stack(post_blocks[k])[:4],
                                      np.stack(base_blocks[k]))
        assert not np.array_equal(p[k][4:], np.ones_like(p[k][4:]))
    log = open(pre + "_Performance.txt").read()
    assert "Test_Result" in log and "Training_iter_start: 4" in log


def test_resume_after_epoch_one_matches_uninterrupted(tmp_path):
    full = run_training(_base_cfg(tmp_path / "full", epochs=2), verbose=False,
                        device="cpu")
    run_training(_base_cfg(tmp_path / "cut", epochs=1, checkpoint_every=1),
                 verbose=False, device="cpu")
    resumed = run_training(_base_cfg(tmp_path / "cut", epochs=2, resume=1,
                                     checkpoint_every=1), verbose=False,
                           device="cpu")
    assert [h["epoch"] for h in resumed.history] == [2]
    for k, v in params_to_numpy(full.params).items():
        np.testing.assert_array_equal(params_to_numpy(resumed.params)[k], v)
    name = "T_MACKAY_Weight_End4.txt"
    assert (open(tmp_path / "full" / name).read()
            == open(tmp_path / "cut" / name).read())
    assert full.history[2]["valid"] == resumed.history[0]["valid"]


def test_cli_train_evaluate_and_weights(tmp_path, capsys):
    from ldpc_error_floor_tpu_torch.cli import main
    cfg_path = str(tmp_path / "base.json")
    _base_cfg(tmp_path / "W", epochs=1).to_json(cfg_path)
    assert main(["train", "--config", cfg_path, "--device", "cpu"]) == 0
    assert "done; best metric" in capsys.readouterr().out
    assert main(["evaluate", "--config", cfg_path, "--batch", "32",
                 "--frames", "64", "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["snr"] for r in rows] == [2.0, 3.0]
    assert all(0.0 <= r["fer"] <= r["fer_last"] <= 1.0 for r in rows)
    assert main(["weights"]) == 0
    assert "wman_N0576_R34_z24_base20: sharing (3, 3, 3), 20 iterations" in \
        capsys.readouterr().out


def test_random_codeword_training_and_collect_mode(tmp_path):
    """train_on_zero_word = 0 trains BCE on encoded random words; sampling
    type 2 trains nothing and appends the never-corrected valid words to
    {out_dir}/Uncor.txt."""
    res = run_training(_base_cfg(tmp_path / "rand", train_on_zero_word=0, loss_type=0,
                                 epochs=1), verbose=False, device="cpu")
    assert res.history[1]["train_loss"] > 0.0
    cfg = _base_cfg(tmp_path / "col", sampling_type=2, snrs=[1.0], epochs=1)
    res = run_training(cfg, verbose=False, device="cpu")
    assert all(h["train_loss"] == 0.0 for h in res.history)
    rows = read_uncor_file(str(tmp_path / "col" / "Uncor.txt"))
    genie = sum(h["valid"][2][0] for h in res.history) * cfg.valid_num
    assert rows.shape == (round(genie), 96) and rows.shape[0] > 0

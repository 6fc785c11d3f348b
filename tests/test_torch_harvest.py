"""The port's uncorrected-word harvester, its resume, the Uncor file format
against the JAX package's, and the collection pipeline on the CPU.

Tolerances: harvested rows equal (==) to the LLR columns the decoder
flags; Uncor files byte-identical to the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.io.uncor_files import append_uncor_file as jax_append
from ldpc_error_floor_tpu.io.uncor_files import read_uncor_file as jax_read
from ldpc_error_floor_tpu_torch import cli
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io import (append_uncor_file, read_uncor_file,
                                           write_weight_file)
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, init_weights)
from ldpc_error_floor_tpu_torch.pipelines import (ExperimentConfig,
                                                  run_collection,
                                                  split_uncor_dataset)
from ldpc_error_floor_tpu_torch.sim import UncorHarvester

torch.set_num_threads(1)

MACKAY = "MACKAY_N96_K48"


@pytest.fixture(scope="module")
def setup():
    code = get_code(MACKAY)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(decoding_type=1), spec, graph=graph,
                     device="cpu")
    ch = AWGNChannel(code, decoding_type=1, device="cpu")
    return code, dec, ch, init_weights(spec, graph, device="cpu")


@pytest.mark.parametrize("cap", [128, 4])
def test_harvester_rows_equal_uncor_columns(setup, cap):
    """The harvested rows are the flagged LLR columns of each batch, in
    order, at most `cap` per batch; `hits` counts them all."""
    code, dec, ch, params = setup
    h = UncorHarvester(dec, ch, batch=128, cap=cap)
    words = h.collect(params, 2.0, torch.Generator().manual_seed(3),
                      target_words=10 ** 9, max_frames=384)
    gen = torch.Generator().manual_seed(3)
    sigma = float(np.float32(code.snr_sigmas([2.0])[0]))
    want, hits = [], 0
    for _ in range(3):
        llr = ch.sample(gen, torch.full((128,), sigma))
        mask = dec.apply(params, llr, collect="stats").uncor_mask
        hits += int(mask.sum())
        want.append(llr[:, mask][:, :cap].T.numpy())
    want = np.concatenate(want)
    assert h.frames == 384 and h.hits == hits > cap
    np.testing.assert_array_equal(words, want)
    assert bool(dec.apply(params, torch.from_numpy(words.T.copy()),
                          collect="stats").uncor_mask.all())


def test_harvester_resume_appends_identically(setup, tmp_path):
    code, dec, ch, params = setup
    h = UncorHarvester(dec, ch, batch=128, cap=128)
    f_full = str(tmp_path / "full.txt")
    h.collect(params, 2.0, torch.Generator().manual_seed(5), target_words=10 ** 9,
              max_frames=512, out_file=f_full)
    rows_full = read_uncor_file(f_full)
    assert rows_full.shape[0] > 0

    f_res, ckpt = str(tmp_path / "resumed.txt"), str(tmp_path / "harvest.json")
    h.collect(params, 2.0, torch.Generator().manual_seed(5), target_words=10 ** 9,
              max_frames=256, out_file=f_res, ckpt_path=ckpt, ckpt_every_s=0.0)
    # the resumed run takes its generator state from the checkpoint
    h.collect(params, 2.0, torch.Generator().manual_seed(99), target_words=10 ** 9,
              max_frames=512, out_file=f_res, ckpt_path=ckpt, ckpt_every_s=0.0)
    assert h.frames == 512
    np.testing.assert_array_equal(read_uncor_file(f_res), rows_full)


def test_harvester_resume_truncates_post_checkpoint_rows(setup, tmp_path):
    """Rows appended after the last checkpoint (a crash before the next
    one) are drawn again by the resumed generator: the resume truncates
    them, so the file does not count them twice."""
    code, dec, ch, params = setup
    h = UncorHarvester(dec, ch, batch=128, cap=128)
    f_full = str(tmp_path / "full.txt")
    h.collect(params, 2.0, torch.Generator().manual_seed(5), target_words=10 ** 9,
              max_frames=512, out_file=f_full)
    rows_full = read_uncor_file(f_full)

    f_res, ckpt = str(tmp_path / "resumed.txt"), str(tmp_path / "harvest.json")
    h.collect(params, 2.0, torch.Generator().manual_seed(5), target_words=10 ** 9,
              max_frames=256, out_file=f_res, ckpt_path=ckpt, ckpt_every_s=0.0)
    with open(f_res) as f:
        extra = f.read().splitlines(keepends=True)
    with open(f_res, "a") as f:
        f.writelines(extra[:3])  # the crash-window appends
    h.collect(params, 2.0, torch.Generator(), target_words=10 ** 9,
              max_frames=512, out_file=f_res, ckpt_path=ckpt, ckpt_every_s=0.0)
    np.testing.assert_array_equal(read_uncor_file(f_res), rows_full)


def test_append_uncor_file_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    llrs = np.round(rng.normal(0, 4, (7, 96)) * 2) / 2
    llrs[0, :5] = [0.0, -0.0, 0.25, -7.5, 20.0]
    llrs = llrs.astype(np.float32)
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    for rows in (llrs[:3], llrs[3:]):  # two appends
        append_uncor_file(str(ours), rows)
        jax_append(str(theirs), rows)
    assert ours.read_bytes() == theirs.read_bytes()
    first = ours.read_text().splitlines()[0].split("\t")
    assert first[:3] == ["0.0", "0.0", "0.0"] and len(first) == 99
    np.testing.assert_array_equal(read_uncor_file(str(ours)), jax_read(str(theirs)))
    np.testing.assert_array_equal(read_uncor_file(str(ours), max_rows=2),
                                  jax_read(str(theirs))[:2])
    with pytest.raises(ValueError, match="need 9"):
        read_uncor_file(str(ours), max_rows=9)


def test_run_collection_split_and_cli(tmp_path, capsys):
    # QMS: the LLRs lie on the 0.5 grid, which '%.1f' keeps exactly
    cfg = ExperimentConfig(code=MACKAY, sharing=(3, 0, 3), decoding_type=2,
                           iters_max=3, snrs=[2.0], seed=1)
    wfile = str(tmp_path / "w.txt")
    write_weight_file(wfile, (3, 0, 3), {"cn": [np.float32([1.0])] * 3,
                                         "ucn": None,
                                         "vn": [np.float32([1.0])] * 3})
    out = str(tmp_path / "Uncor.txt")
    words = run_collection(cfg, weight_file=wfile, target_words=40, batch=64,
                           out_file=out, device="cpu")
    assert words.shape[0] >= 40 and words.shape[1] == 96
    np.testing.assert_array_equal(read_uncor_file(out), words)
    split_uncor_dataset(out, MACKAY, str(tmp_path / "in"), 20, 10, 10)
    base = tmp_path / "in" / f"[Uncor]_{MACKAY}"
    for suffix, lo, hi in ((".txt", 0, 20), ("_Valid.txt", 20, 30),
                           ("_Test.txt", 30, 40)):
        np.testing.assert_array_equal(jax_read(f"{base}{suffix}"), words[lo:hi])
    with pytest.raises(ValueError, match="rows <"):
        split_uncor_dataset(out, MACKAY, str(tmp_path / "in"), 10 ** 6, 1, 1)

    cfg_file = str(tmp_path / "cfg.json")
    cfg.to_json(cfg_file)
    out2 = str(tmp_path / "Uncor2.txt")
    assert cli.main(["collect", "--config", cfg_file, "--weights", wfile,
                     "--words", "40", "--batch", "64", "--out", out2,
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"snr_db": 2.0, "words": words.shape[0], "out": out2}
    np.testing.assert_array_equal(read_uncor_file(out2), words)  # same seed
    assert cli.main(["split-uncor", "--uncor", out2, "--code", MACKAY,
                     "--input-dir", str(tmp_path / "in2"), "--train", "5",
                     "--valid", "5", "--test", "5"]) == 0
    with pytest.raises(ValueError, match="single SNR"):
        run_collection(ExperimentConfig(code=MACKAY, sharing=(3, 0, 3),
                                        snrs=[1.0, 2.0]), weight_file=wfile,
                       device="cpu")

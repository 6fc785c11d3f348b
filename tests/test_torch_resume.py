"""The port's simulator resume checkpoint, random-codeword simulation and
GF(2) encoder (the encoder against the JAX package's).

Resume is exact: a point killed and re-run from its checkpoint ends with
the counters of an uninterrupted run.  The encoder's rank, k and parity map
equal the JAX package's, and its words satisfy H*x = 0.
"""

import json

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.codes import Encoder as JaxEncoder
from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import (Encoder, TannerGraph,
                                              available_codes, get_code,
                                              gf2_rref)
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, init_weights)
from ldpc_error_floor_tpu_torch.sim import FERSimulator
from ldpc_error_floor_tpu_torch.sim import fer as fer_module

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
    return code, graph, dec, ch, init_weights(spec, graph, device="cpu")


def _fields(pt):
    """A point's counters and rates, NaN read as None (it never equals itself)."""
    return {k: None if v != v else v for k, v in vars(pt).items()
            if k not in ("seconds", "frames_per_sec")}


@pytest.mark.parametrize("stop", ["genie", "syndrome"])
def test_sim_resume_matches_uninterrupted(setup, tmp_path, stop):
    code, graph, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=128, stop=stop)
    full = sim.run_point(params, 2.0, torch.Generator().manual_seed(13),
                         max_frames=640, target_frame_errors=None)
    ckpt = str(tmp_path / "pt.json")
    part = sim.run_point(params, 2.0, torch.Generator().manual_seed(13),
                         max_frames=256, target_frame_errors=None,
                         ckpt_path=ckpt, ckpt_every_s=0.0)
    assert part.frames == 256 and json.load(open(ckpt))["done"]
    # the resumed point takes its generator state from the checkpoint
    resumed = sim.run_point(params, 2.0, torch.Generator().manual_seed(77),
                            max_frames=640, target_frame_errors=None,
                            ckpt_path=ckpt, ckpt_every_s=0.0)
    assert _fields(resumed) == _fields(full)
    assert full.fer_last > 0


def test_sim_resume_from_a_mid_point_record(setup, tmp_path, monkeypatch):
    """A record written mid-run (one step in flight) resumes at the first
    batch not yet counted."""
    code, graph, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=128)
    full = sim.run_point(params, 2.0, torch.Generator().manual_seed(2),
                         max_frames=768, target_frame_errors=None)
    ckpt = str(tmp_path / "pt.json")
    records = []
    save = fer_module._save_ckpt
    monkeypatch.setattr(fer_module, "_save_ckpt",
                        lambda path, obj: (records.append(obj), save(path, obj)))
    sim.run_point(params, 2.0, torch.Generator().manual_seed(2),
                  max_frames=768, target_frame_errors=None,
                  ckpt_path=ckpt, ckpt_every_s=0.0)
    monkeypatch.undo()
    mid = records[1]  # after the second batch was counted, the third in flight
    assert mid["frames"] == 256 and not mid["done"]
    with open(ckpt, "w") as f:
        json.dump(mid, f)
    resumed = sim.run_point(params, 2.0, torch.Generator(), max_frames=768,
                            target_frame_errors=None, ckpt_path=ckpt)
    assert _fields(resumed) == _fields(full)


def test_sim_resume_ignores_other_snr(setup, tmp_path):
    code, graph, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=128)
    ckpt = str(tmp_path / "pt.json")
    sim.run_point(params, 2.0, torch.Generator().manual_seed(1), max_frames=256,
                  target_frame_errors=None, ckpt_path=ckpt, ckpt_every_s=0.0)
    other = sim.run_point(params, 3.0, torch.Generator().manual_seed(1),
                          max_frames=256, target_frame_errors=None,
                          ckpt_path=ckpt, ckpt_every_s=0.0)
    assert other.frames == 256 and other.frames_per_sec > 0


def test_sim_completed_point_reruns_as_done(setup, tmp_path):
    code, graph, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=128)
    ckpt = str(tmp_path / "pt.json")
    first = sim.run_point(params, 2.0, torch.Generator().manual_seed(3),
                          max_frames=256, target_frame_errors=None,
                          ckpt_path=ckpt, ckpt_every_s=1e9)  # only the final record
    rerun = sim.run_point(params, 2.0, torch.Generator(), max_frames=256,
                          target_frame_errors=None, ckpt_path=ckpt)
    assert _fields(rerun) == _fields(first) and rerun.frames_per_sec == 0.0
    tgt = sim.run_point(params, 2.0, torch.Generator(), max_frames=10 ** 6,
                        target_frame_errors=1, ckpt_path=ckpt)
    assert tgt.frames == 256  # the resumed counters already meet the target
    more = sim.run_point(params, 2.0, torch.Generator(), max_frames=512,
                         target_frame_errors=None, ckpt_path=ckpt)
    assert more.frames == 512


def test_run_curve_resume_repeats_uninterrupted(setup, tmp_path):
    code, graph, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=128)
    snrs = [1.5, 2.5]
    full = sim.run_curve(params, snrs, torch.Generator().manual_seed(4),
                         max_frames=384, target_frame_errors=None)
    prefix = str(tmp_path / "curve")
    sim.run_curve(params, snrs[:1], torch.Generator().manual_seed(4),
                  ckpt_prefix=prefix, max_frames=384, target_frame_errors=None)
    resumed = sim.run_curve(params, snrs, torch.Generator().manual_seed(4),
                            ckpt_prefix=prefix, max_frames=384,
                            target_frame_errors=None)
    assert [_fields(p) for p in resumed] == [_fields(p) for p in full]
    assert resumed[0].frames_per_sec == 0.0 and resumed[1].frames_per_sec > 0
    assert full[0].fer_genie != full[1].fer_genie


def test_gf2_rref_known_matrix():
    H = np.array([[1, 1, 0, 1, 0],
                  [0, 1, 1, 0, 1],
                  [1, 0, 1, 1, 1]], np.uint8)
    R, piv = gf2_rref(H)
    assert piv == [0, 1] and R.shape == (2, 5)
    for row in H:  # every original row reduces to 0 against the RREF rows
        x = row.copy()
        for i, c in enumerate(piv):
            if x[c]:
                x ^= R[i]
        assert not x.any()


@pytest.mark.parametrize("name", available_codes())
def test_encoder_emits_valid_codewords(name):
    code = get_code(name)
    graph = TannerGraph(code)
    enc = Encoder(graph, device="cpu")
    jenc = JaxEncoder(JaxGraph(jax_get_code(name)))
    assert (enc.rank, enc.k) == (jenc.rank, jenc.k)
    np.testing.assert_array_equal(enc._S.numpy(), np.asarray(jenc._S))
    bits = enc.random_codewords(torch.Generator().manual_seed(0), 8)
    assert bits.dtype == torch.float32 and bits.shape == (code.n_full, 8)
    synd = (graph.H.astype(np.int64) @ bits.numpy().astype(np.int64)) % 2
    assert not synd.any()
    assert bool(enc.syndrome_ok(bits).all())
    assert bits.sum() > 0
    ss, se = code.short
    if ss > 0:
        assert not bits[ss - 1:se].any()


def test_random_codeword_simulation(setup):
    """codewords='random' encodes fresh words; the FER agrees with the
    zero word's within loose Monte-Carlo bounds (channel symmetry)."""
    code, graph, dec, ch, params = setup
    pts = {}
    for mode in ("zero", "random"):
        sim = FERSimulator(dec, ch, batch=256, codewords=mode)
        pts[mode] = sim.run_point(params, 2.0, torch.Generator().manual_seed(5),
                                  max_frames=2048, target_frame_errors=None)
    assert pts["random"].frames == pts["zero"].frames == 2048
    assert 0.0 < pts["random"].fer_genie < 1.0
    assert abs(pts["random"].fer_genie - pts["zero"].fer_genie) < 0.1
    with pytest.raises(ValueError, match="codewords"):
        FERSimulator(dec, ch, batch=256, codewords="gaussian")


def test_sample_codewords_folds_to_the_zero_word(setup):
    """Sign-folded LLRs of an encoded word are the zero word's LLRs on the
    noise folded alike (MS channel: no quantization)."""
    code, graph, dec, ch, params = setup
    B = 16
    bits = Encoder(graph, device="cpu").random_codewords(
        torch.Generator().manual_seed(1), B)
    sig = torch.full((B,), float(code.snr_sigmas([2.0])[0]))
    llr = ch.sample_codewords(torch.Generator().manual_seed(2), sig, bits)
    noise = torch.randn((code.n_full, B), generator=torch.Generator().manual_seed(2))
    fold = 1.0 - 2.0 * bits
    want = ch._llr(-1.0 + (noise * fold) * sig[None, :], sig)
    assert torch.equal(llr * fold, want)
    assert bool(((llr >= 0) == (bits > 0)).float().mean() > 0.8)

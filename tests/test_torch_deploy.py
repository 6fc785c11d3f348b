"""The port's syndrome stop ("deploy") against the JAX scan decoder on the
same numpy-made LLRs and weights.

Tolerances: wrong flags, bit-error counts, iteration counts and
detected_fail integer-equal; QMS APPs bit-equal (==); MS APPs within
atol 1e-4 / rtol 1e-5 (the port sums C->V messages in slot order, XLA may
reduce in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, init_weights,
                                               params_from_numpy)
from ldpc_error_floor_tpu_torch.sim import FERSimulator

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"

# (code, sharing, decoding_type, SNR dB, T), as in tests/test_deploy.py
CASES = [
    (WMAN, (3, 0, 3), 2, 3.25, 8),
    (WMAN, (3, 3, 3), 2, 3.25, 6),
    ("802_11n_N648_R56_z27", (3, 0, 3), 2, 4.0, 6),
    ("MACKAY_N96_K48", (3, 0, 3), 1, 3.0, 6),
]


def _inputs(code_name, sharing, dec, snr, T, B, seed=7, ones=False):
    """numpy weights in [0.7, 1.3] (or ones) and LLRs formed by the JAX
    channel from numpy noise."""
    rng = np.random.default_rng(seed)
    jcode = jax_get_code(code_name)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=sharing, n_iters=T)
    params = {}
    for kind in ("cn", "ucn", "vn"):
        d = jspec.dim(kind, jgraph)
        params[kind] = None if d == 0 else (
            np.ones((T, d), np.float32) if ones else
            rng.uniform(0.7, 1.3, (T, d)).astype(np.float32))
    sigma = np.full((B,), np.float32(jcode.snr_sigmas([snr])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((jcode.n_full, B)) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode, decoding_type=dec, q_bit=5)._llr(
        jnp.asarray(y), jnp.asarray(sigma)))
    return jcode, jgraph, jspec, params, llr


def _jax(params):
    return {k: None if v is None else jnp.asarray(v) for k, v in params.items()}


def _port_decoder(code_name, sharing, dec, T):
    code = get_code(code_name)
    spec = WeightSpec(sharing=sharing, n_iters=T)
    return NMSDecoder(code, DecoderConfig(decoding_type=dec, q_bit=5), spec,
                      graph=TannerGraph(code), device="cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}")
def test_deploy_plain_matches_jax_scan(case):
    code_name, sharing, dec, snr, T = case
    jcode, jgraph, jspec, params, llr = _inputs(code_name, sharing, dec, snr, T, 48)
    ref = JaxDecoder(jcode, JaxConfig(decoding_type=dec, q_bit=5), jspec,
                     graph=jgraph).decode(_jax(params), jnp.asarray(llr),
                                          collect="deploy")
    dec_t = _port_decoder(code_name, sharing, dec, T)
    res = dec_t.apply(params_from_numpy(params, device="cpu"),
                      torch.from_numpy(llr), collect="deploy")
    assert not dec_t.kernel.launches
    for name in ("wrong", "bit_errors", "iters", "detected_fail"):
        got, want = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(res.undetected.numpy(), np.asarray(ref.undetected))
    if dec == 2:
        np.testing.assert_array_equal(res.app.numpy(), np.asarray(ref.app))
    else:
        np.testing.assert_allclose(res.app.numpy(), np.asarray(ref.app),
                                   rtol=1e-5, atol=1e-4)
    it = res.iters.numpy()
    assert it.min() < T  # some words stop early


def test_deploy_matches_jax_stats_oracle():
    """Per-word deploy outputs == the first syndrome-satisfied row of the
    JAX scan's stats run with track_syndrome."""
    T = 8
    jcode, jgraph, jspec, params, llr = _inputs(WMAN, (3, 0, 3), 2, 3.25, T, 32,
                                                ones=True)
    st = JaxDecoder(jcode, JaxConfig(decoding_type=2, q_bit=5, track_syndrome=True),
                    jspec, graph=jgraph).decode(_jax(params), jnp.asarray(llr),
                                                collect="stats")
    synd, errf, nerr = (np.asarray(st.syndrome_ok), np.asarray(st.err_flags),
                        np.asarray(st.bit_errors))
    dep = _port_decoder(WMAN, (3, 0, 3), 2, T).apply(
        params_from_numpy(params, device="cpu"), torch.from_numpy(llr),
        collect="deploy")
    stopped_early = 0
    for b in range(synd.shape[1]):
        ts = np.nonzero(synd[:, b])[0]
        stop = int(ts[0]) if len(ts) else T - 1
        stopped_early += int(len(ts) > 0 and ts[0] < T - 1)
        assert bool(errf[stop, b]) == bool(dep.wrong[b])
        assert int(nerr[stop, b]) == int(dep.bit_errors[b])
        assert (stop + 1 if len(ts) else T) == int(dep.iters[b])
        assert (len(ts) == 0) == bool(dep.detected_fail[b])
    assert stopped_early > 0


def test_deploy_undetected_errors_are_wrong_codewords():
    """undetected == wrong & syndrome satisfied: H*x == 0 rechecked on the
    port's APPs (Polar_64_48, where miscorrections occur)."""
    jcode, jgraph, jspec, params, llr = _inputs("Polar_64_48", (3, 0, 3), 1, 3.0,
                                                6, 256, ones=True)
    res = _port_decoder("Polar_64_48", (3, 0, 3), 1, 6).apply(
        params_from_numpy(params, device="cpu"), torch.from_numpy(llr),
        collect="deploy")
    bits = (res.app.numpy() >= 0).astype(np.int32)
    synd_ok = ((jgraph.H.astype(np.int32) @ bits) % 2 == 0).all(axis=0)
    np.testing.assert_array_equal(~synd_ok, res.detected_fail.numpy())
    undet = res.undetected.numpy()
    np.testing.assert_array_equal(undet, res.wrong.numpy() & synd_ok)
    assert undet.sum() > 0


class _Injected:
    """Channel stand-in that hands out prepared LLR batches in order."""

    def __init__(self, code, batches):
        self.code = code
        self.device = torch.device("cpu")
        self.batches = list(batches)
        self.calls = 0

    def sample(self, generator, sigma_lanes, out=None):
        llr = torch.from_numpy(self.batches[self.calls % len(self.batches)])
        self.calls += 1
        return llr if out is None else out.copy_(llr)


def test_fer_simulator_syndrome_matches_summed_deploy_counters():
    T, B, nb = 5, 64, 3
    batches = [_inputs("MACKAY_N96_K48", (3, 0, 3), 1, 2.5, T, B, seed=s,
                       ones=True)[4] for s in range(nb)]
    jcode, jgraph, jspec, params, _ = _inputs("MACKAY_N96_K48", (3, 0, 3), 1,
                                              2.5, T, B, ones=True)
    jdec = JaxDecoder(jcode, JaxConfig(decoding_type=1), jspec, graph=jgraph)
    tot = [0, 0, 0, 0]
    for llr in batches:
        r = jdec.decode(_jax(params), jnp.asarray(llr), collect="deploy")
        tot[0] += int(np.asarray(r.bit_errors).sum())
        tot[1] += int(np.asarray(r.wrong).sum())
        tot[2] += int(np.asarray(r.undetected).sum())
        tot[3] += int(np.asarray(r.iters).sum())
    assert tot[1] > 0

    dec = _port_decoder("MACKAY_N96_K48", (3, 0, 3), 1, T)
    code = dec.code
    sim = FERSimulator(dec, _Injected(code, batches), batch=B, stop="syndrome")
    pt = sim.run_point(init_weights(dec.spec, dec.graph, device="cpu"), 2.5,
                       torch.Generator(), max_frames=nb * B,
                       target_frame_errors=None)
    frames = nb * B
    assert pt.frames == frames
    assert pt.ber_last == tot[0] / (frames * code.n_full)
    assert pt.fer_last == tot[1] / frames
    assert pt.fer_undetected == tot[2] / frames
    assert pt.avg_iters == tot[3] / frames
    assert np.isnan(pt.fer_genie)
    assert 1.0 <= pt.avg_iters <= T


def test_fer_simulator_syndrome_stops_on_errors_at_stop():
    """stop='syndrome' counts its target against errors at each frame's
    stop (there is no genie count)."""
    dec = _port_decoder("MACKAY_N96_K48", (3, 0, 3), 1, 2)
    code = dec.code
    ch = _Injected(code, [np.ones((code.n_full, 4), np.float32)])  # all wrong
    sim = FERSimulator(dec, ch, batch=4, stop="syndrome")
    pt = sim.run_point(init_weights(dec.spec, dec.graph, device="cpu"), 3.0,
                       torch.Generator(), max_frames=400, target_frame_errors=5)
    assert pt.frames == 8 and pt.fer_last == 1.0 and 1.0 <= pt.avg_iters <= 2.0
    with pytest.raises(ValueError, match="bad stop mode"):
        FERSimulator(dec, ch, batch=4, stop="oracle")

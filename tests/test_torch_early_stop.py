"""The port's genie early stop (plain version, grouped as the CUDA kernel
groups words) against the JAX scan decoder on the same numpy-made inputs.

The JAX scan runs a fixed T; a group of words stops after the first
iteration by which each has decoded once.  Held exactly: the genie-failure
mask equals the scan's; every row up to a group's stop equals the scan's
row; later rows are 0.  The APP left behind is the scan's APP of the
group's stop iteration (from ``collect='apps'``): QMS bit-equal, MS within
atol 1e-4 / rtol 1e-5.
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
from ldpc_error_floor_tpu.models import load_params as jax_load_params
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, load_params,
                                               params_from_numpy)
from ldpc_error_floor_tpu_torch.sim import FERSimulator

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"

# (code, sharing, decoding_type, SNR dB, T, B, weights)
# (at these SNRs some groups stop early and some words fail)
CASES = [
    (WMAN, (3, 3, 3), 2, 3.5, 8, 96, "base20"),
    ("MACKAY_N96_K48", (3, 0, 3), 1, 4.5, 8, 256, "rand"),
    ("802_11n_N648_R56_z27", (3, 0, 3), 2, 4.5, 8, 128, "rand"),
]


def _inputs(code_name, sharing, dec, snr, T, B, weights, seed=5):
    rng = np.random.default_rng(seed)
    jcode = jax_get_code(code_name)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=sharing, n_iters=T)
    if weights == "base20":
        params = {k: None if v is None else np.asarray(v)[:T] for k, v in
                  jax_load_params(JaxSpec(sharing=sharing, n_iters=20), jgraph,
                                  f"{code_name}_base20").items()}
    else:
        params = {k: None if jspec.dim(k, jgraph) == 0 else
                  rng.uniform(0.7, 1.3, (T, jspec.dim(k, jgraph))).astype(np.float32)
                  for k in ("cn", "ucn", "vn")}
    sigma = np.full((B,), np.float32(jcode.snr_sigmas([snr])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((jcode.n_full, B)) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode, decoding_type=dec, q_bit=5)._llr(
        jnp.asarray(y), jnp.asarray(sigma)))
    return jcode, jgraph, jspec, params, llr


def _group_stop(err, group):
    """[B] index of each word's group's stop iteration, from fixed-T flags."""
    T, B = err.shape
    still = np.cumprod(err, axis=0).astype(bool)
    pad = (-B) % group
    alive = np.pad(still, ((0, 0), (0, pad))).reshape(T, -1, group).any(axis=2)
    stop = np.where(alive.all(axis=0), T - 1, np.argmin(alive, axis=0))
    return np.repeat(stop, group)[:B]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][:6]}_{c[2]}")
def test_early_stop_plain_matches_jax_scan(case):
    code_name, sharing, dec, snr, T, B, weights = case
    jcode, jgraph, jspec, params, llr = _inputs(code_name, sharing, dec, snr, T,
                                                B, weights)
    jdec = JaxDecoder(jcode, JaxConfig(decoding_type=dec, q_bit=5), jspec,
                      graph=jgraph)
    jp = {k: None if v is None else jnp.asarray(v) for k, v in params.items()}
    ref = jdec.decode(jp, jnp.asarray(llr), collect="stats")
    apps = np.asarray(jdec.decode(jp, jnp.asarray(llr), collect="apps").apps)
    err_r, nerr_r = np.asarray(ref.err_flags), np.asarray(ref.bit_errors)

    code = get_code(code_name)
    dec_t = NMSDecoder(code, DecoderConfig(decoding_type=dec, q_bit=5,
                                           early_stop=True),
                       WeightSpec(sharing=sharing, n_iters=T),
                       graph=TannerGraph(code), device="cpu")
    G = dec_t.kernel.group
    res = dec_t.apply(params_from_numpy(params, device="cpu"),
                      torch.from_numpy(llr), collect="stats")
    err, nerr, app = (res.err_flags.numpy(), res.bit_errors.numpy(),
                      res.app_last.numpy())
    np.testing.assert_array_equal(res.uncor_mask.numpy(), err_r.all(axis=0))
    stop = _group_stop(err_r, G)
    assert (stop < T - 1).any() and (stop == T - 1).any()
    rows = np.arange(T)[:, None]
    np.testing.assert_array_equal(err, np.where(rows <= stop, err_r, False))
    np.testing.assert_array_equal(nerr, np.where(rows <= stop, nerr_r, 0))
    app_r = apps[stop, :, np.arange(B)].T  # [N*z, B]: each word's stop APP
    if dec == 2:
        np.testing.assert_array_equal(app, app_r)
    else:
        np.testing.assert_allclose(app, app_r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("group", [1, 3])
def test_early_stop_group_sizes(group):
    """Any grouping keeps the genie mask; group 1 stops each word alone."""
    code_name, sharing, dec, snr, T, B, weights = CASES[1]
    jcode, jgraph, jspec, params, llr = _inputs(code_name, sharing, dec, snr, T,
                                                B, weights)
    ref = JaxDecoder(jcode, JaxConfig(decoding_type=dec), jspec, graph=jgraph).decode(
        {k: None if v is None else jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(llr), collect="stats")
    err_r = np.asarray(ref.err_flags)
    code = get_code(code_name)
    dec_t = NMSDecoder(code, DecoderConfig(decoding_type=dec),
                       WeightSpec(sharing=sharing, n_iters=T), device="cpu")
    _, err, _ = dec_t.kernel.decode_stats_plain(
        {k: None if v is None else torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(llr), early_stop=True, group=group)
    stop = _group_stop(err_r, group)
    rows = np.arange(T)[:, None]
    np.testing.assert_array_equal(err.numpy(), np.where(rows <= stop, err_r, False))
    np.testing.assert_array_equal(err.numpy().all(axis=0), err_r.all(axis=0))


def test_simulator_early_stop_keeps_genie_counts():
    """The same generator seed gives the same genie error count with and
    without the early stop (the LLRs are drawn alike)."""
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 3, 3), n_iters=20)
    params = load_params(spec, graph, f"{WMAN}_base20", device="cpu")
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    pts = []
    for early in (False, True):
        dec = NMSDecoder(code, DecoderConfig(early_stop=early), spec,
                         graph=graph, device="cpu")
        sim = FERSimulator(dec, AWGNChannel(code, device="cpu"), batch=48)
        pts.append(sim.run_point(params, 2.5, torch.Generator().manual_seed(4),
                                 max_frames=96, target_frame_errors=None))
    assert pts[0].fer_genie == pts[1].fer_genie > 0
    assert pts[1].fer_last <= pts[0].fer_last  # rows after a stop read 0

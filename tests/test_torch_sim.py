"""The port's FER simulator: counters equal to the JAX decoder's on the same
injected LLR batches, the stop rules, a chunk's read composition under the
genie early stop against its batches decoded one at a time, and `cli
simulate --device cpu`."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.models import load_params as jax_load_params
from ldpc_error_floor_tpu_torch import cli
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import Encoder, TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, init_weights,
                                               load_params)
from ldpc_error_floor_tpu_torch.sim import FERSimulator

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5_64 = "5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640"


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


def _decoder(code, sharing, T):
    spec = WeightSpec(sharing=sharing, n_iters=T)
    return NMSDecoder(code, DecoderConfig(), spec, device="cpu"), spec


def test_counters_match_jax_on_injected_batches():
    T, B, nb = 5, 32, 3
    rng = np.random.default_rng(9)
    jcode = jax_get_code(WMAN)
    sigma = np.float32(jcode.snr_sigmas([2.5])[0])
    batches = [np.clip(np.round(2.0 * (-1.0 + sigma * rng.standard_normal(
        (jcode.n_full, B))) / sigma ** 2 / 0.5) * 0.5, -7.5, 7.5)
        .astype(np.float32) for _ in range(nb)]

    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=(3, 3, 3), n_iters=T)
    jdec = JaxDecoder(jcode, JaxConfig(), jspec, graph=jgraph)
    jparams = jax_load_params(jspec, jgraph, f"{WMAN}_base20")
    be = fel = feg = 0
    for llr in batches:
        r = jdec.decode(jparams, jnp.asarray(llr), collect="stats")
        be += int(np.asarray(r.bit_errors[-1]).sum())
        fel += int(np.asarray(r.err_flags[-1]).sum())
        feg += int(np.asarray(r.uncor_mask).sum())
    assert feg > 0

    code = get_code(WMAN)
    dec, spec = _decoder(code, (3, 3, 3), T)
    params = load_params(spec, TannerGraph(code), f"{WMAN}_base20", device="cpu")
    ch = _Injected(code, batches)
    pt = FERSimulator(dec, ch, batch=B).run_point(
        params, 2.5, torch.Generator(), max_frames=nb * B,
        target_frame_errors=None)
    frames = nb * B
    assert ch.calls == nb and pt.frames == frames
    assert pt.ber_last == be / (frames * code.n_full)
    assert pt.fer_last == fel / frames
    assert pt.fer_genie == feg / frames


def _all_wrong_sim(batch):
    """A MacKay decoder fed LLRs of +1 everywhere: every frame is an error."""
    code = get_code("MACKAY_N96_K48")
    dec, spec = _decoder(code, (3, 0, 3), 2)
    ch = _Injected(code, [np.ones((code.n_full, batch), np.float32)])
    params = init_weights(spec, dec.graph, device="cpu")
    return FERSimulator(dec, ch, batch=batch), params, ch


def test_run_point_stop_rules():
    sim, params, ch = _all_wrong_sim(4)
    gen = torch.Generator()
    # strict max_frames: whole batches, never past the bound
    pt = sim.run_point(params, 3.0, gen, max_frames=18, target_frame_errors=None)
    assert pt.frames == 16 and pt.fer_genie == 1.0 and ch.calls == 4
    # target errors: stops at the first batch that reaches it
    pt = sim.run_point(params, 3.0, gen, max_frames=400, target_frame_errors=5)
    assert pt.frames == 8
    # min_frames holds the target stop back
    pt = sim.run_point(params, 3.0, gen, max_frames=400, target_frame_errors=5,
                       min_frames=20)
    assert pt.frames == 20
    with pytest.raises(ValueError, match="below one simulation chunk"):
        sim.run_point(params, 3.0, gen, max_frames=3)


@pytest.mark.parametrize("code_name,sharing,target,weights,snr", [
    (WMAN, (3, 3, 3), 0, f"{WMAN}_base20", 3.0),
    (G5_64, (2, 2, 2), 10, f"{G5_64}_iter50", 3.5),
])
@pytest.mark.parametrize("codewords", ["zero", "random"])
def test_read_composition_equals_batches_decoded_alone(code_name, sharing, target,
                                                       weights, snr, codewords):
    """Under the genie early stop a chunk samples its K batches into one read
    buffer and decodes them by one `read_totals` call: its counters equal
    those of K batches sampled and decoded one at a time, each reduced from
    its rows (bit errors and frames wrong at the last row, frames wrong at
    every row) and summed, from the same generator state, and the generator
    ends where theirs does.  A word ever correct stops, so the two frame
    counts agree."""
    K, B, T = 3, 24, 5
    code = get_code(code_name)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=sharing, n_iters=T)
    dec = NMSDecoder(code, DecoderConfig(target_node=target, early_stop=True), spec,
                     graph=graph, device="cpu")
    params = load_params(spec, graph, weights, device="cpu")
    ch = AWGNChannel(code, device="cpu")
    sim = FERSimulator(dec, ch, batch=B, codewords=codewords, inner_steps=K)
    sigma = float(np.float32(code.snr_sigmas([snr])[0]))
    gen = torch.Generator().manual_seed(7)
    got = sim._chunk(params, gen, sigma)
    after = gen.get_state()
    gen.manual_seed(7)
    encoder = Encoder(graph, device="cpu")
    want = torch.zeros(3, dtype=torch.int64)
    for _ in range(K):
        sig = torch.full((B,), sigma)
        if codewords == "zero":
            llr = ch.sample(gen, sig)
        else:
            bits = encoder.random_codewords(gen, B)
            llr = ch.sample_codewords(gen, sig, bits, fold=True)
        res = dec.decode(params, llr, collect="counts")
        want += torch.stack([res.bit_errors[-1].sum(dtype=torch.int64),
                             res.err_flags[-1].sum(dtype=torch.int64),
                             res.uncor_mask.sum(dtype=torch.int64)])
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert 0 < int(got[2]) < K * B and int(got[1]) == int(got[2])
    assert torch.equal(gen.get_state(), after)


def test_cli_simulate_prints_one_json_line_per_snr(capsys):
    rc = cli.main(["simulate", "--code", WMAN, "--device", "cpu",
                   "--weights", f"{WMAN}_base20", "--iters", "20",
                   "--snrs", "2.0", "3.0", "--batch", "16",
                   "--max-frames", "32", "--seed", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    pts = [json.loads(ln) for ln in lines]
    assert [p["snr_db"] for p in pts] == [2.0, 3.0]
    for p in pts:
        assert p["frames"] in (16, 32) and 0.0 <= p["fer_genie"] <= 1.0
        assert p["fer_genie"] <= p["fer_last"] + 1e-12

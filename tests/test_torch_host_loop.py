"""The port's Monte-Carlo host loop: `FERSimulator(inner_steps=K)` and
`run_point(progress=)` behave as the JAX package's.

K steps of one chunk count what K single steps count from the same
generator state (JAX: `tests/test_sharding.py::
test_inner_steps_counters_match_manual_loop`), the clamp equals JAX's, a
point runs whole chunks and stops at `max_frames`, `progress` is called
every 50 host reads, and a point resumed from a mid-point record with K > 1
ends as an uninterrupted one.  `utils.profiling.trace` writes a Chrome
trace that names an `annotate`d span.  On the CPU a chunk is a loop over K steps;
its CUDA graph on the card is held to the same loop by
`tests/test_torch_kernel_cuda.py`.
"""

import json

import pytest
import torch

from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.sim import FERSimulator as JaxSimulator
from ldpc_error_floor_tpu_torch import cli
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, init_weights)
from ldpc_error_floor_tpu_torch.sim import FERSimulator
from ldpc_error_floor_tpu_torch.sim import fer as fer_module
from ldpc_error_floor_tpu_torch.utils import annotate, trace

torch.set_num_threads(1)

MACKAY = "MACKAY_N96_K48"
WMAN = "wman_N0576_R34_z24"


@pytest.fixture(scope="module")
def setup():
    code = get_code(MACKAY)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(decoding_type=1), spec, graph=graph,
                     device="cpu")
    ch = AWGNChannel(code, decoding_type=1, device="cpu")
    return code, dec, ch, init_weights(spec, graph, device="cpu")


def _fields(pt):
    """A point's counters and rates, NaN read as None (it never equals itself)."""
    return {k: None if v != v else v for k, v in vars(pt).items()
            if k not in ("seconds", "frames_per_sec")}


@pytest.mark.parametrize("stop,codewords", [("genie", "zero"), ("syndrome", "zero"),
                                            ("genie", "random")])
def test_chunk_equals_k_single_steps(setup, stop, codewords):
    code, dec, ch, params = setup
    simk = FERSimulator(dec, ch, batch=64, stop=stop, codewords=codewords,
                        inner_steps=4)
    sim1 = FERSimulator(dec, ch, batch=64, stop=stop, codewords=codewords)
    assert simk.inner_steps == 4
    sigma = float(code.snr_sigmas([2.0])[0])
    gen = torch.Generator().manual_seed(5)
    got = simk._chunk(params, gen, sigma)
    state_after = gen.get_state()
    gen.manual_seed(5)
    want = sum(sim1._chunk(params, gen, sigma) for _ in range(4))
    assert torch.equal(got, want) and int(got[1]) > 0
    assert torch.equal(gen.get_state(), state_after)


@pytest.mark.parametrize("code_name,batch,steps,target", [
    (MACKAY, 64, 4, 0),             # no clamp
    (WMAN, 1 << 20, 1 << 20, 0),    # the int32 headroom bites: K = 3
    (WMAN, 4096, 1000, 0),          # bites: K = 910
    (WMAN, 4096, 5000, 6),          # systematic columns only: K = 3640
])
def test_inner_steps_clamp_equals_jax(code_name, batch, steps, target):
    jcode = jax_get_code(code_name)
    jspec = JaxSpec(sharing=(3, 0, 3), n_iters=2)
    jdec = JaxDecoder(jcode, JaxConfig(target_node=target), jspec, graph=JaxGraph(jcode))
    jsim = JaxSimulator(jdec, JaxChannel(jcode), batch=batch, inner_steps=steps)
    code = get_code(code_name)
    dec = NMSDecoder(code, DecoderConfig(target_node=target),
                     WeightSpec(sharing=(3, 0, 3), n_iters=2), device="cpu")
    sim = FERSimulator(dec, AWGNChannel(code, device="cpu"), batch=batch,
                       inner_steps=steps)
    assert sim.inner_steps == jsim.inner_steps
    assert (sim.inner_steps < steps) == (code_name == WMAN)


def test_inner_steps_below_one_is_an_error(setup):
    code, dec, ch, params = setup
    with pytest.raises(ValueError, match="inner_steps"):
        FERSimulator(dec, ch, batch=64, inner_steps=0)


def test_run_point_counts_whole_chunks_and_stops_at_max_frames(setup):
    code, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=32, inner_steps=3)
    pt = sim.run_point(params, 2.0, torch.Generator().manual_seed(1),
                       max_frames=300, target_frame_errors=None)
    assert pt.frames == 288  # three chunks of 96; a fourth would pass 300
    with pytest.raises(ValueError, match="one simulation chunk"):
        sim.run_point(params, 2.0, torch.Generator(), max_frames=95)
    # a target stops the point at the end of the chunk that meets it
    tgt = sim.run_point(params, 1.0, torch.Generator().manual_seed(1),
                        max_frames=96 * 20, target_frame_errors=5)
    assert tgt.frames % 96 == 0 and round(tgt.fer_genie * tgt.frames) >= 5
    assert tgt.frames < 96 * 20


def test_progress_is_called_every_50_host_reads(setup):
    code, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=4, inner_steps=2)
    seen = []
    pt = sim.run_point(params, 2.0, torch.Generator().manual_seed(3),
                       max_frames=8 * 120, target_frame_errors=None,
                       progress=lambda c: seen.append(c.frames))
    assert pt.frames == 8 * 120
    assert seen == [8 * 50, 8 * 100]
    # run_curve passes it to each point
    seen.clear()
    sim.run_curve(params, [2.0, 3.0], torch.Generator().manual_seed(3),
                  max_frames=8 * 60, target_frame_errors=None,
                  progress=lambda c: seen.append(c.frames))
    assert seen == [8 * 50, 8 * 50]


def test_resume_with_inner_steps_equals_uninterrupted(setup, tmp_path, monkeypatch):
    """A record written mid-run (one chunk in flight) resumes at the first
    chunk not yet counted."""
    code, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=64, inner_steps=3)
    full = sim.run_point(params, 2.0, torch.Generator().manual_seed(2),
                         max_frames=5 * 192, target_frame_errors=None)
    ckpt = str(tmp_path / "pt.json")
    records = []
    save = fer_module._save_ckpt
    monkeypatch.setattr(fer_module, "_save_ckpt",
                        lambda path, obj: (records.append(obj), save(path, obj)))
    sim.run_point(params, 2.0, torch.Generator().manual_seed(2),
                  max_frames=5 * 192, target_frame_errors=None,
                  ckpt_path=ckpt, ckpt_every_s=0.0)
    monkeypatch.undo()
    mid = records[1]  # the second chunk counted, the third in flight
    assert mid["frames"] == 2 * 192 and not mid["done"]
    with open(ckpt, "w") as f:
        json.dump(mid, f)
    resumed = sim.run_point(params, 2.0, torch.Generator(), max_frames=5 * 192,
                            target_frame_errors=None, ckpt_path=ckpt)
    assert _fields(resumed) == _fields(full) and full.fer_last > 0


def test_cli_simulate_inner_steps(capsys):
    rc = cli.main(["simulate", "--device", "cpu", "--code", MACKAY, "--iters", "2",
                   "--sharing", "0", "0", "0", "--snrs", "2.0", "--batch", "16",
                   "--inner-steps", "3", "--max-frames", "100",
                   "--target-errors", "1000000"])
    assert rc == 0
    pt = json.loads(capsys.readouterr().out.strip())
    assert pt["frames"] == 96


def test_trace_writes_a_chrome_trace_naming_the_annotated_span(setup, tmp_path):
    code, dec, ch, params = setup
    sim = FERSimulator(dec, ch, batch=16, inner_steps=2)
    with trace(str(tmp_path / "t")) as prof:
        with annotate("run_point_span"):
            sim.run_point(params, 2.0, torch.Generator().manual_seed(1),
                          max_frames=64, target_frame_errors=None)
    text = (tmp_path / "t" / "trace.json").read_text()
    assert "run_point_span" in text and json.loads(text)["traceEvents"]
    assert any(e.key == "run_point_span" for e in prof.key_averages())
    with trace(None) as none:
        torch.ones(3).sum()
    assert none is None and sorted(p.name for p in tmp_path.iterdir()) == ["t"]

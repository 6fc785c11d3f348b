"""The port's boosted composition against the JAX package's, the exact
anchor it gives (boosted30 repeats base20 in its first 20 rows), and
`cli simulate --base-weights` on the CPU.

Tolerances: composed weights equal (==); per-iteration flags and counts
integer-equal.
"""

import json

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.models import load_params as jax_load_params
from ldpc_error_floor_tpu.models.boosted import \
    compose_boosted_params as jax_compose
from ldpc_error_floor_tpu_torch import cli
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io import write_weight_file
from ldpc_error_floor_tpu_torch.models import (BoostedDecoder, DecoderConfig,
                                               NMSDecoder, WeightSpec,
                                               compose_boosted_params,
                                               load_params, params_from_numpy)

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
MACKAY = "MACKAY_N96_K48"


def _np(params):
    return {k: None if v is None else np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("base_sharing,post_sharing,fixed", [
    ((3, 0, 3), (3, 3, 3), 4),   # scalar rows; base has no UCN rows
    ((2, 2, 2), (5, 5, 5), 4),   # per-node rows into temporal post rows
    ((1, 0, 2), (1, 1, 2), 0),   # per-edge rows
])
def test_compose_matches_jax(base_sharing, post_sharing, fixed):
    rng = np.random.default_rng(2)
    jgraph = JaxGraph(jax_get_code(MACKAY))
    graph = TannerGraph(get_code(MACKAY))
    base_spec = WeightSpec(sharing=base_sharing, n_iters=4)
    post_spec = WeightSpec(sharing=post_sharing, n_iters=6, fixed_iter=fixed)
    jbase = JaxSpec(sharing=base_sharing, n_iters=4)
    jpost = JaxSpec(sharing=post_sharing, n_iters=6, fixed_iter=fixed)

    def rand(spec):
        return {k: None if spec.n_rows(k) == 0 else rng.uniform(
            0.5, 1.5, (spec.n_rows(k), spec.dim(k, graph))).astype(np.float32)
            for k in ("cn", "ucn", "vn")}

    base, post = rand(base_spec), rand(post_spec)
    want = _np(jax_compose(jgraph, jbase, base, jpost, post))
    got = compose_boosted_params(graph, base_spec, params_from_numpy(base, "cpu"),
                                 post_spec, params_from_numpy(post, "cpu"))
    for k in ("cn", "ucn", "vn"):
        if want[k] is None:
            assert got[k] is None
        else:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="at least as deep"):
        compose_boosted_params(graph, post_spec, params_from_numpy(post, "cpu"),
                               base_spec, params_from_numpy(base, "cpu"))


def test_bundled_boosted30_composition_matches_jax():
    jgraph = JaxGraph(jax_get_code(WMAN))
    graph = TannerGraph(get_code(WMAN))
    s20, s30 = WeightSpec(sharing=(3, 3, 3), n_iters=20), \
        WeightSpec(sharing=(3, 3, 3), n_iters=30)
    j20, j30 = JaxSpec(sharing=(3, 3, 3), n_iters=20), JaxSpec(sharing=(3, 3, 3), n_iters=30)
    want = _np(jax_compose(jgraph, j20, jax_load_params(j20, jgraph, f"{WMAN}_base20"),
                           j30, jax_load_params(j30, jgraph, f"{WMAN}_boosted30")))
    base20 = load_params(s20, graph, f"{WMAN}_base20", device="cpu")
    boosted30 = load_params(s30, graph, f"{WMAN}_boosted30", device="cpu")
    got = compose_boosted_params(graph, s20, base20, s30, boosted30)
    for k in ("cn", "ucn", "vn"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        # the bundled boosted30 already repeats base20 in its first 20 rows
        np.testing.assert_array_equal(boosted30[k][:20].numpy(), base20[k].numpy())


def test_boosted30_prefix_rows_equal_base20():
    """On the same LLRs the boosted decoder's rows 0..19 equal base20's,
    integer for integer, and its genie failures are a subset of base20's."""
    code = get_code(WMAN)
    graph = TannerGraph(code)
    s20, s30 = WeightSpec(sharing=(3, 3, 3), n_iters=20), \
        WeightSpec(sharing=(3, 3, 3), n_iters=30)
    base20 = load_params(s20, graph, f"{WMAN}_base20", device="cpu")
    comp = compose_boosted_params(graph, s20, base20, s30,
                                  load_params(s30, graph, f"{WMAN}_boosted30",
                                              device="cpu"))
    rng = np.random.default_rng(8)
    B = 48
    sigma = np.full((B,), np.float32(code.snr_sigmas([2.75])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((code.n_full, B)) * sigma).astype(np.float32)
    llr = AWGNChannel(code, device="cpu")._llr(torch.from_numpy(y),
                                               torch.from_numpy(sigma))
    boosted = BoostedDecoder(code, DecoderConfig(), s30, comp, boundary=20,
                             graph=graph, device="cpu")
    res_b = boosted.decode(llr)
    res_s = NMSDecoder(code, DecoderConfig(), s20, graph=graph,
                       device="cpu").apply(base20, llr, collect="stats")
    assert torch.equal(res_b.err_flags[:20], res_s.err_flags)
    assert torch.equal(res_b.bit_errors[:20], res_s.bit_errors)
    assert torch.equal(boosted.base_failure_mask(res_b), res_s.uncor_mask)
    assert not bool((res_b.uncor_mask & ~res_s.uncor_mask).any())
    assert int(res_s.uncor_mask.sum()) > 0
    with pytest.raises(ValueError, match="boundary"):
        BoostedDecoder(code, DecoderConfig(), s30, comp, boundary=31,
                       graph=graph, device="cpu")


@pytest.mark.parametrize("mode", ["genie", "early_stop", "syndrome"])
def test_cli_simulate_boosted_composition(tmp_path, capsys, mode):
    """`simulate --base-weights ... --boundary ...` composes and runs on
    the CPU, with each stop."""
    base_file = str(tmp_path / "base.txt")
    write_weight_file(base_file, (3, 0, 3),
                      {"cn": [np.float32([0.9])] * 3, "ucn": None,
                       "vn": [np.float32([1.0])] * 3})
    argv = ["simulate", "--code", MACKAY, "--device", "cpu",
            "--sharing", "3", "0", "3", "--iters", "5",
            "--base-weights", base_file, "--boundary", "3",
            "--decoding-type", "1", "--snrs", "2.0",
            "--batch", "64", "--max-frames", "128",
            "--target-errors", "1000000"]
    if mode == "early_stop":
        argv.append("--early-stop")
    elif mode == "syndrome":
        argv += ["--stop", "syndrome"]
    assert cli.main(argv) == 0
    pt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert pt["frames"] == 128 and 0.0 <= pt["fer_last"] <= 1.0
    if mode == "syndrome":
        assert 1.0 <= pt["avg_iters"] <= 5.0 and pt["fer_undetected"] <= pt["fer_last"]
    else:
        assert 0.0 <= pt["fer_genie"] <= pt["fer_last"] + 1e-12
    bad = list(argv)
    bad[bad.index("--boundary") + 1] = "9"  # past --iters
    with pytest.raises(SystemExit):
        cli.main(bad)

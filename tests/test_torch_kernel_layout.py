"""Host-side parts of the CUDA kernels' design that the CPU can check.

- The quantizer: the kernels multiply by 1/step where the plain versions
  divide by step.  For a power-of-two step the two are the same float for
  every input (each is the correctly rounded value of the same real number),
  so the kernels stay bit-equal to the plain versions; the wrappers refuse
  any other step.
- The training pair's residual streams: tile-major, tiles of W words (the
  backward's G), the last tile padded.
"""

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import DecoderConfig, WeightSpec
from ldpc_error_floor_tpu_torch.ops import fused_decoder
from ldpc_error_floor_tpu_torch.ops.fused_decoder import FusedNMSKernel, kernel_grid
from ldpc_error_floor_tpu_torch.ops.fused_train import FusedTrainKernel, train_launch_shape
from ldpc_error_floor_tpu_torch.ops.ste import _GRIDS, quantize_llr

WMAN = "wman_N0576_R34_z24"


def _sweep(step: float, clip: float, seed: int = 0) -> np.ndarray:
    """float32 values: random bit patterns over every finite exponent, all
    the subnormals' extremes, the grid's ties (odd multiples of step/2), both
    clip bounds and their neighbours, and values near powers of two."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, 400_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    sub = np.concatenate([np.arange(1, 5000, dtype=np.uint32),
                          np.arange(0x007FF000, 0x00800000, dtype=np.uint32)]
                         ).view(np.float32)
    halves = (np.arange(-4000, 4001, dtype=np.float32) + np.float32(0.5)) * np.float32(step)
    bounds = []
    for b in (clip, -clip, step / 2, -step / 2):
        v = np.float32(b)
        for _ in range(64):
            bounds += [v]
            v = np.nextafter(v, np.float32(np.inf))
        v = np.float32(b)
        for _ in range(64):
            v = np.nextafter(v, np.float32(-np.inf))
            bounds += [v]
    pow2 = np.ldexp(np.float32(1.0), np.arange(-149, 128)).astype(np.float32)
    near = np.concatenate([pow2, np.nextafter(pow2, np.float32(0)),
                           np.nextafter(pow2, np.float32(np.inf))])
    u = rng.uniform(-4 * clip, 4 * clip, 200_000).astype(np.float32)
    out = np.concatenate([x, sub, -sub, halves, np.asarray(bounds, np.float32),
                          near, -near, u, np.float32([0.0, -0.0])])
    return out[np.isfinite(out)]


@pytest.mark.parametrize("q_bit", sorted(_GRIDS))
def test_reciprocal_quantizer_equals_division(q_bit):
    """x * (1/step) rounds to the same float as x / step, bit for bit, and
    the kernel's quantizer rint(x * (1/step)) * step clipped equals the plain
    version's `quantize_llr` (which divides)."""
    step, clip = _GRIDS[q_bit]
    x = _sweep(step, clip, seed=q_bit + 10)
    inv = np.float32(1.0 / step)
    assert float(inv) * step == 1.0  # exact: a power of two
    with np.errstate(over="ignore", under="ignore"):
        mul = x * inv
        div = x / np.float32(step)
    np.testing.assert_array_equal(mul.view(np.uint32), div.view(np.uint32))
    cfg = DecoderConfig(decoding_type=2, q_bit=q_bit)
    k_step, k_inv, k_clip = kernel_grid(cfg)
    assert (k_step, k_inv, k_clip) == (step, 1.0 / step, clip)
    xt = torch.from_numpy(x)
    kernel_q = torch.clamp(torch.round(xt * k_inv) * k_step, -k_clip, k_clip)
    plain_q = quantize_llr(xt, q_bit)
    assert torch.equal(kernel_q.view(torch.int32), plain_q.view(torch.int32))


def test_wrappers_refuse_a_step_that_is_not_a_power_of_two(monkeypatch):
    """The kernels multiply by 1/step, which equals dividing only for a
    power-of-two step: both wrappers raise before building anything."""
    monkeypatch.setattr(fused_decoder, "qms_grid", lambda q: (0.75, 6.0))
    cfg = DecoderConfig(decoding_type=2, q_bit=5)
    with pytest.raises(ValueError, match="power-of-two"):
        kernel_grid(cfg)
    assert kernel_grid(DecoderConfig(decoding_type=1)) == (1.0, 1.0, cfg.clip_llr)
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=2)
    w = {"cn": torch.ones((2, 1)), "ucn": None, "vn": torch.ones((2, 1))}
    llr = torch.zeros((code.n_full, 4))
    kern = FusedNMSKernel(graph, cfg, spec)
    with pytest.raises(ValueError, match="power-of-two"):
        kern._launch(w, llr, fused_decoder.FIXED)
    train = FusedTrainKernel(graph, cfg, spec)
    with pytest.raises(ValueError, match="power-of-two"):
        train._forward((w["cn"], None, w["vn"]), llr, True)
    assert not kern.launches and not train.launches


def test_launch_plan_is_computed_once():
    """The pair's launch shapes and quantizer grid are worked out at first
    use and kept: B4 writes the streams in the tile width B5 launches with,
    from the same plan."""
    graph = TannerGraph(get_code(WMAN))
    spec = WeightSpec(sharing=(3, 3, 3), n_iters=3)
    kern = FusedTrainKernel(graph, DecoderConfig(decoding_type=2, app_t0=2), spec)
    plan = kern.plan
    assert kern.plan is plan
    assert plan.fwd == train_launch_shape(graph, spec, False)
    assert plan.bwd == train_launch_shape(graph, spec, True)
    assert plan.grid == kernel_grid(kern.cfg)
    assert kern.tile_width == plan.bwd[0]
    assert kern.streams(5, torch.device("cpu"), True)[1].shape[-1] == plan.bwd[0]


# (sharing, decoding type, B): ragged batches, the last tile padded
STREAM_CASES = [((3, 0, 3), 2, 1001), ((3, 3, 3), 2, 13), ((3, 0, 3), 0, 1001),
                ((2, 2, 2), 0, 3)]


@pytest.mark.parametrize("case", STREAM_CASES, ids=lambda c: f"{c[0]}_{c[1]}_B{c[2]}")
def test_tile_major_stream_allocation(case):
    """B4's residual streams: hist [tiles, T, E*z, W] and cres [tiles, T,
    R*M*z, W] with W the backward's G and tiles = ceil(B / W); the APP
    window keeps [T-t0, target*z, B]."""
    sharing, dec, B = case
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=sharing, n_iters=3)
    kern = FusedTrainKernel(graph, DecoderConfig(decoding_type=dec, app_t0=1), spec)
    W = kern.tile_width
    assert W == train_launch_shape(graph, spec, True, sp=dec == 0)[0]
    assert W in (1, 2, 4, 8, 16, 32) and B % W != 0
    apps, hist, cres = kern.streams(B, torch.device("cpu"), True)
    tiles = -(-B // W)
    assert tiles * W - B < W
    assert apps.shape == (2, code.n_full, B)
    assert hist.shape == (tiles, 3, graph.E * code.z, W) and hist.is_contiguous()
    R = kern.cres_rows
    if R:
        assert cres.shape == (tiles, 3, R * code.M * code.z, W) and cres.is_contiguous()
    else:
        assert cres is None and dec == 0 and not spec.ucn_enabled
    # one tile's run of one iteration is contiguous: what B5 stages
    run = graph.E * code.z * W
    assert hist[tiles - 1, 2].data_ptr() - hist.data_ptr() == 4 * ((tiles - 1) * 3 + 2) * run
    apps_only, none_h, none_c = kern.streams(B, torch.device("cpu"), False)
    assert apps_only.shape == apps.shape and none_h is None and none_c is None

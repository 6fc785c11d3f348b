"""Host-side parts of the CUDA kernels' design that the CPU can check.

- The quantizer: the kernels multiply by 1/step where the plain versions
  divide by step.  For a power-of-two step the two are the same float for
  every input (each is the correctly rounded value of the same real number),
  so the kernels stay bit-equal to the plain versions; the wrappers refuse
  any other step.
- The training pair's residual streams: tile-major, tiles of W words (the
  backward's G), the last tile padded.
- The decode kernels' code-domain state under QMS (`code_grid`): every
  value the loop stores is an integer number of u, the C->V bytes keep the
  sign of zero, the V->C bytes read magnitude 0 as kEps, the bit totals
  fit an int16, and the integer quantizer, extrinsic-min and byte-select
  steps give the float loop's values bit for bit (emulated here in plain
  PyTorch, op for op as csrc/fused_nms_kernel.cuh writes them).
- The decode kernels' launch shapes and shared-memory layouts, float and
  code state, held to the kernel's launch bounds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu_torch.codes import TannerGraph, available_codes, get_code
from ldpc_error_floor_tpu_torch.models import DecoderConfig, WeightSpec
from ldpc_error_floor_tpu_torch.ops import fused_decoder
from ldpc_error_floor_tpu_torch.ops.fused_decoder import (_CODE_BLOCKS, _CODE_THREADS,
                                                          _DEPLOY_BLOCKS, _DEPLOY_THREADS,
                                                          _EARLY_STOP_BLOCKS, _LUT_INTS,
                                                          _SMEM_LIMIT, _SMEM_PER_SM,
                                                          _SMEM_RESERVED,
                                                          _SP_REG_DEG,
                                                          _SP_THREADS,
                                                          _SP_WARPS_PER_SM,
                                                          _TWO_BLOCK_THREADS,
                                                          _TWO_BLOCK_WARPS_PER_SM,
                                                          FusedNMSKernel, _smem_bytes,
                                                          _table_bytes, code_grid,
                                                          kernel_grid, launch_shape)
from ldpc_error_floor_tpu_torch.ops.fused_train import (FusedTrainKernel, _smem_bwd,
                                                        train_launch_shape)
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


# ----- the code-domain state of the decode kernels -----------------------------------

EPS = np.float32(1.0e-4)      # kEps
PAD = np.float32(1.0e4)       # kPadMag
PADC = 1 << 30                # kPadC
NEG_ZERO = 0x80               # kNegZero
I32 = torch.int32


def _sext7(b: torch.Tensor) -> torch.Tensor:
    """c2v_code: bits 0-6 of a C->V byte, sign-extended (-0's byte reads 0)."""
    return (b.to(I32) << 25) >> 25


def _c2v_byte(v: torch.Tensor, uinv: float) -> torch.Tensor:
    """The C->V byte of float grid values v (what pass 2's select stores)."""
    k = torch.round(v * uinv).to(I32)
    neg0 = (v == 0) & torch.signbit(v)
    return torch.where(neg0, NEG_ZERO, k & 0x7F)


def _c2v_float(b: torch.Tensor, u: float) -> torch.Tensor:
    """A C->V byte's float value, -0 for the -0 byte."""
    f = _sext7(b).to(torch.float32) * np.float32(u)
    return torch.where(b == NEG_ZERO, torch.tensor(-0.0), f)


def _quantize_code(pre: torch.Tensor, clipc: int, qshift: int) -> torch.Tensor:
    """Msg::quantize_code, op for op."""
    x = pre
    if qshift > 0:
        x = ((pre + (1 << (qshift - 1)) - 1 + ((pre >> qshift) & 1)) >> qshift) << qshift
    return torch.clamp(x, -clipc, clipc)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(I32)


@pytest.mark.parametrize("q_bit", sorted(_GRIDS))
def test_code_grid_for_every_bundled_code(q_bit):
    """u is the largest power of two dividing step and clip; every bundled
    code's bit totals (channel value plus its largest VN degree of
    messages) fit an int16 and every message a 7-bit code; a grid whose
    codes do not fit is refused."""
    step, clip = _GRIDS[q_bit]
    cfg = DecoderConfig(decoding_type=2, q_bit=q_bit)
    for name in available_codes():
        graph = TannerGraph(get_code(name))
        u, uinv, clipc, qshift = code_grid(cfg, graph)
        assert clip / u == clipc and step / u == 2 ** qshift and u * uinv == 1.0
        assert (clip / (2 * u)) % 1 != 0 or (step / (2 * u)) % 1 != 0  # largest
        assert clipc <= 63 and clipc * (graph.Dv + 1) <= 16383
    graph = TannerGraph(get_code(WMAN))
    for grid in ((0.5, 127.0), (2.0 ** -8, 1.0)):  # 254 and 256 units per message
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fused_decoder, "qms_grid", lambda q, g=grid: g)
            with pytest.raises(ValueError, match="code-domain"):
                code_grid(cfg, graph)


@pytest.mark.parametrize("q_bit", sorted(_GRIDS))
def test_code_state_round_trips_every_stored_value(q_bit):
    """Every value the loop stores, as the kernel encodes it and reads it
    back, bit for bit (sign of zero included): C->V messages (the grid, +0,
    -0, the clip), V->C messages (the grid and kEps: magnitude 0), bit
    totals up to the bundled codes' largest VN degree, and the float
    slot-order sum of a bit's C->V messages against the code sum (-0 only
    when every term is -0)."""
    step, clip = _GRIDS[q_bit]
    u, uinv, clipc, _ = code_grid(DecoderConfig(decoding_type=2, q_bit=q_bit),
                                  TannerGraph(get_code(WMAN)))
    # C->V: every grid value of either sign, both zeros, the clip
    k = torch.arange(-clipc, clipc + 1, dtype=I32)
    vals = torch.cat([k.to(torch.float32) * np.float32(u), torch.tensor([0.0, -0.0, clip, -clip])])
    b = _c2v_byte(vals, uinv)
    assert int(b.min()) >= 0 and int(b.max()) <= 0xFF
    assert torch.equal(_bits(_c2v_float(b, u)), _bits(vals))
    # V->C: sign-magnitude, magnitude 0 is +kEps (the nudged zero)
    x = torch.cat([k[k != 0], torch.tensor([0], dtype=I32)])
    vb = x.abs() | ((x >> 24) & 0x80)
    mag = torch.where((vb & 0x7F) == 0, torch.tensor(EPS), (vb & 0x7F).to(torch.float32) * np.float32(u))
    xf = torch.where(vb >= 0x80, -mag, mag)
    ref = torch.where(x == 0, torch.tensor(EPS), x.to(torch.float32) * np.float32(u))
    assert torch.equal(_bits(xf), _bits(ref))
    # bit totals: int16 codes up to the channel value plus 16 messages,
    # doubled, the bit's hard decision in bit 0
    dv = max(TannerGraph(get_code(n)).Dv for n in available_codes())
    tot = torch.arange(-clipc * (dv + 1), clipc * (dv + 1) + 1, dtype=I32)
    for bit in (0, 1):
        packed = ((tot << 1) | bit).to(torch.int16).to(I32)
        assert torch.equal(packed >> 1, tot) and bool(((packed & 1) == bit).all())
    totf = tot.to(torch.float32) * np.float32(u)
    assert torch.equal(torch.round(totf * np.float32(uinv)).to(I32), tot)
    # the slot-order float sum of Dv bytes against the code sum
    rng = np.random.default_rng(q_bit + 40)
    for dv_ in (1, 2, 3, 6, 16):
        pick = torch.from_numpy(rng.integers(0, vals.numel(), (20000, dv_)))
        pick[:2000] = vals.numel() - 3  # all -0
        pick[2000:3000, 0] = vals.numel() - 4  # +0 first, then any
        terms = vals[pick]
        fsum = terms[:, 0].clone()
        for d in range(1, dv_):
            fsum = fsum + terms[:, d]
        tb = _c2v_byte(terms, uinv)
        csum = _sext7(tb).sum(dim=1)
        all_neg0 = (tb == NEG_ZERO).all(dim=1)
        got = torch.where(all_neg0 & (csum == 0), torch.tensor(-0.0),
                          csum.to(torch.float32) * np.float32(u))
        assert torch.equal(_bits(got), _bits(fsum))


@pytest.mark.parametrize("q_bit", sorted(_GRIDS))
def test_integer_quantizer_equals_the_float_one(q_bit):
    """quantize_code(pre) * u equals the float quantizer (and its zero
    nudge) on pre * u for every pre a V->C derivation can meet: a bit
    total less a C->V code."""
    u, uinv, clipc, qshift = code_grid(DecoderConfig(decoding_type=2, q_bit=q_bit),
                                       TannerGraph(get_code(WMAN)))
    pre = torch.arange(-clipc * 18, clipc * 18 + 1, dtype=I32)
    q = _quantize_code(pre, clipc, qshift)
    ref = quantize_llr(pre.to(torch.float32) * np.float32(u), q_bit)
    # equal as values; a zero of either sign nudges to +kEps in both loops
    assert torch.equal(q.to(torch.float32) * np.float32(u), ref)


@pytest.mark.parametrize("q_bit", sorted(_GRIDS))
@pytest.mark.parametrize("offset", [False, True])
def test_check_update_in_codes_equals_the_float_loop(q_bit, offset):
    """Phase B of the code state against the float loop's phase B, for
    random checks of degree 2-15: pass 1's integer min1/min2 and sign
    parity on sign-magnitude V->C bytes, the two precomputed output bytes
    per extrinsic magnitude and pass 2's byte select give, decoded, the
    float loop's C->V messages bit for bit (the sign of zero included)."""
    step, clip = _GRIDS[q_bit]
    u, uinv, clipc, _ = code_grid(DecoderConfig(decoding_type=2, q_bit=q_bit),
                                  TannerGraph(get_code(WMAN)))
    rng = np.random.default_rng(q_bit + (110 if offset else 10))
    fu = np.float32(u)

    def quant(x):
        return torch.clamp(torch.round(x * np.float32(1.0 / step)) * np.float32(step), -clip, clip)

    n_checks = 0
    for deg in (2, 3, 6, 15):
        R = 4000
        xc = torch.from_numpy(rng.integers(-clipc, clipc + 1, (R, deg))).to(I32)
        xc[: R // 4] = torch.from_numpy(rng.integers(-1, 2, (R // 4, deg)))  # zeros, ties
        w = torch.from_numpy(rng.uniform(0.0, 1.2 if offset else 1.3, (R, 1)).astype(np.float32))
        # the float loop (fused_nms_kernel.cuh, pass 1 and pass 2)
        x = torch.where(xc == 0, torch.tensor(EPS), xc.to(torch.float32) * fu)
        a = x.abs()
        m1 = a.amin(dim=1, keepdim=True)
        first = torch.arange(deg)[None] == a.argmin(dim=1, keepdim=True)
        m2 = torch.where(first, PAD, a).amin(dim=1, keepdim=True)
        sg = torch.where(x > 0, -1.0, 1.0)
        sgn_tot = torch.prod(sg, dim=1, keepdim=True)
        mag = torch.where(a == m1, m2, m1)
        mag = torch.where(mag <= EPS, mag - EPS, mag)
        out = mag * (-(sgn_tot * sg))
        wmag = mag - w if offset else mag * w
        wmag = torch.where(wmag > 0, wmag, torch.tensor(0.0))
        wmag = quant(wmag)
        ref = wmag * torch.sign(out)
        # the code loop: sign-magnitude V->C bytes, integer mins and parity
        vb = xc.abs() | ((xc >> 24) & 0x80)
        am = vb & 0x7F
        m1c = am.amin(dim=1, keepdim=True)
        m2c = torch.where(torch.arange(deg)[None] == am.argmin(dim=1, keepdim=True),
                          PADC, am).amin(dim=1, keepdim=True)
        nneg = (xc < 0).sum(dim=1, keepdim=True)
        ppar = (deg - nneg) & 1

        def out_bytes(mc):
            m = torch.where(mc >= PADC, PAD, torch.where(mc == 0, EPS, mc.to(torch.float32) * fu))
            m = torch.where(m <= EPS, m - EPS, m)
            wm = m - w if offset else m * w
            wm = quant(torch.where(wm > 0, wm, torch.tensor(0.0)))
            wc = torch.round(wm * np.float32(uinv)).to(I32)
            byte = wc | (torch.where(wc != 0, (-wc) & 0x7F, NEG_ZERO) << 8)
            return torch.where(m == 0, 0, byte)

        K = out_bytes(m2c) | (out_bytes(m1c) << 16)
        sel = ((am != m1c).to(I32) << 1) | (((vb >> 7) ^ ppar) & 1)
        got_b = (K >> (8 * sel)) & 0xFF
        got = _c2v_float(got_b, u)
        assert torch.equal(_bits(got), _bits(ref))
        n_checks += R
    assert n_checks == 16000


def _cuh_constant(name: str) -> int:
    src = (Path(fused_decoder.__file__).parent.parent / "csrc" / "fused_nms_kernel.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("name", available_codes())
def test_decode_launch_shapes_hold_to_the_kernel_layout(name):
    """For every bundled code, fixed-T (with and without the syndrome
    flags of ``track_syndrome``), early-stop and deploy modes, float
    state (MS), SP's float state and code state:
    the launch shape within the kernel's launch bound (the .cuh constants:
    the syndrome stop's own blocks per SM under the code state, blocks of
    at most 768 threads for SP, one block for SP's early stop and MS),
    the most words whose blocks fit an SM as many times as the bound asks
    (else whose one block fits; SP's fixed T and syndrome stop: a block
    that fits, `sp_launch_shape`), and the shared bytes of the layout: the
    staged head, then for the code state the counts (and deploy or
    syndrome flags) and
    the output-byte table padded to 16 bytes, the lifted slot table, int16
    totals (each with its bit's decision), C->V bytes; for SP the lifted
    slot table before the float state; the code state's early stop (the
    genie stop per word) its own: no weights, the lanes' control ints, the
    lifted slot table, totals and C->V bytes."""
    assert (_CODE_THREADS, _CODE_BLOCKS, _EARLY_STOP_BLOCKS, _DEPLOY_THREADS,
            _DEPLOY_BLOCKS) == (
        _cuh_constant("kCodeThreads"), _cuh_constant("kCodeBlocks"),
        _cuh_constant("kEarlyStopBlocks"), _cuh_constant("kDeployThreads"),
        _cuh_constant("kDeployBlocks"))
    assert _SP_THREADS == _cuh_constant("kSPThreads")
    assert _SP_REG_DEG == _cuh_constant("kSPRegDeg")
    assert (_TWO_BLOCK_THREADS, _TWO_BLOCK_WARPS_PER_SM) == (
        _cuh_constant("kTwoBlockThreads"), 2 * _cuh_constant("kTwoBlockThreads") // 32)
    # the SP bound's registers (65536 per SM over its threads, in steps of
    # 8) and the warps an SM's four schedulers hold at that count
    assert _SP_WARPS_PER_SM == 4 * (16384 // ((65536 // _SP_THREADS) // 8 * 8 * 32))
    assert _DEPLOY_BLOCKS > _CODE_BLOCKS
    assert _LUT_INTS == 2 * _cuh_constant("kLutRow") >= 2 * (63 + 2)
    code = get_code(name)
    graph = TannerGraph(code)
    N, M, z, E = code.N, code.M, code.z, graph.E
    head = _table_bytes(N, M, E) + -(-4 * (2 * E + N) // 16) * 16
    for ucn in (False, True):
        for deploy, es, track in ((False, False, False), (False, False, True),
                                  (False, True, False), (True, False, False)):
            for state in ("float", "sp", "code"):
                code_state, sp = state == "code", state == "sp"
                G, threads = launch_shape(graph, ucn, deploy, code_state, es, sp, track)
                if code_state and deploy:
                    top, blocks = _DEPLOY_THREADS, _DEPLOY_BLOCKS
                elif code_state:
                    top, blocks = _CODE_THREADS, _EARLY_STOP_BLOCKS if es else _CODE_BLOCKS
                elif sp:
                    top, blocks = _SP_THREADS, 1
                else:
                    top, blocks = 1024, 1
                assert G in (1, 2, 4, 8, 16, 32) and threads % 32 == 0
                assert threads % G == 0 and threads <= top
                smem = _smem_bytes(N, M, z, E, G, ucn, deploy, code_state, sp, track, es)
                cnt = (4 if deploy or track else 2) * G
                bits = N * z * G if ucn or deploy or track else 0
                if code_state and es:  # lanes of the genie stop per word
                    assert smem == (_table_bytes(N, M, E) + -(-4 * (8 * G + 16) // 16) * 16
                                    + 4 * E * z + 5 * N * z * G + E * z * G)
                elif code_state:  # the decisions ride in bit 0 of the totals
                    assert smem == (head + -(-4 * (cnt + _LUT_INTS) // 16) * 16
                                    + 8 * E * z + 2 * N * z * G + E * z * G)
                else:
                    assert smem == (head + (8 * E * z if sp else 0)
                                    + 4 * (E + N) * z * G + 4 * cnt + bits)
                fits = lambda s, n: s <= _SMEM_LIMIT and n * (s + _SMEM_RESERVED) <= _SMEM_PER_SM
                loop = lambda g: _smem_bytes(N, M, z, E, g, ucn, code=True)
                size = lambda g: _smem_bytes(N, M, z, E, g, ucn, deploy, code_state, sp,
                                             track, es)
                if sp and not es:  # the fastest shape measured, not the most words
                    assert fits(smem, 1)
                elif code_state and es and fits(loop(1), blocks):  # lanes: the loop's
                    # words at these blocks, halved while they do not fit
                    G_loop = next(g for g in (32, 16, 8, 4, 2, 1) if fits(loop(g), blocks))
                    assert G <= G_loop and fits(smem, blocks)
                    assert G == G_loop or not fits(size(2 * G), blocks)
                elif fits(size(1), blocks):
                    assert fits(smem, blocks)
                    assert G == 32 or not fits(size(2 * G), blocks)
                else:
                    assert fits(smem, 1)
        spec = WeightSpec(sharing=(3, 3 if ucn else 0, 3), n_iters=2)
        kern = FusedNMSKernel(graph, DecoderConfig(decoding_type=2), spec)
        es = FusedNMSKernel(graph, DecoderConfig(decoding_type=2, early_stop=True), spec)
        assert kern.code and kern.group == launch_shape(graph, ucn, False, True)[0]
        # each word stops alone; the launch keeps `launch_shape`'s G lanes
        lut = fused_decoder.word_stop_lut_iters(graph, 2, 3)
        G_es = launch_shape(graph, ucn, False, True, True, lut_iters=lut)[0]
        assert es.group == 1
        assert es.launch_shape(fused_decoder.EARLY_STOP) == (
            G_es, launch_shape(graph, ucn, False, True, True, lut_iters=lut)[1],
            _smem_bytes(N, M, z, E, G_es, ucn, code=True, early_stop=True, lut_iters=lut))
        assert G_es <= kern.group
        assert kern.launch_shape(fused_decoder.DEPLOY) == (
            *launch_shape(graph, ucn, True, True),
            _smem_bytes(N, M, z, E, launch_shape(graph, ucn, True, True)[0], ucn, True, True))
        sp = FusedNMSKernel(graph, DecoderConfig(decoding_type=0), spec)
        for mode in (fused_decoder.FIXED, fused_decoder.EARLY_STOP, fused_decoder.DEPLOY):
            deploy, es_mode = mode == fused_decoder.DEPLOY, mode == fused_decoder.EARLY_STOP
            G, threads = launch_shape(graph, ucn, deploy, False, es_mode, True)
            assert sp.launch_shape(mode) == (
                G, threads, _smem_bytes(N, M, z, E, G, ucn, deploy, False, True))
    assert not FusedNMSKernel(graph, DecoderConfig(decoding_type=1),
                              WeightSpec(sharing=(3, 0, 3), n_iters=2)).code


G5_64 = "5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640"


@pytest.mark.parametrize("name, sharing, T, shape, lut", [
    (WMAN, (3, 3, 3), 20, (8, 384), 20), (WMAN, (3, 3, 3), 30, (8, 384), 0),
    (G5_64, (2, 2, 2), 50, (2, 320), 0)])
def test_word_stop_layout_keeps_the_early_stop_shape(name, sharing, T, shape, lut):
    """The code state's early stop (the genie stop per word) on wman (base20;
    boosted30, whose output-byte tables of 30 iterations do not fit) and 5G z 64
    (per-check weights: no tables): the G lanes, threads and four blocks per
    SM that the early stop had before it stopped words one by one; the
    output-byte tables of every iteration staged where they keep that
    shape; and `_smem_bytes` equal to the .cuh's `word_stop_layout`."""
    graph = TannerGraph(get_code(name))
    code = graph.code
    N, M, z, E = code.N, code.M, code.z, graph.E
    spec = WeightSpec(sharing=sharing, n_iters=T)
    es = FusedNMSKernel(graph, DecoderConfig(decoding_type=2, early_stop=True), spec)
    G, threads, smem = es.launch_shape(fused_decoder.EARLY_STOP)
    assert (G, threads) == shape and es.group == 1
    assert fused_decoder.word_stop_lut_iters(graph, T, sharing[0]) == lut
    assert _EARLY_STOP_BLOCKS * (smem + _SMEM_RESERVED) <= _SMEM_PER_SM
    src = (Path(fused_decoder.__file__).parent.parent / "csrc" / "fused_nms_kernel.cuh").read_text()
    body = re.search(r"WordStopLayout word_stop_layout\(.*?WordStopLayout L;(.*?)return L;",
                     src, re.S).group(1)
    names = {"N": N, "M": M, "z": z, "E": E, "G": G, "lut_iters": lut,
             "kLutInts": 2 * _cuh_constant("kLutRow"), "table_bytes": _table_bytes,
             "kWordStopCtl": _cuh_constant("kWordStopCtl")}
    for line in body.strip().split(";"):
        if line.strip():
            field, expr = line.split("=", 1)
            names[field.strip().replace(".", "_")] = eval(expr.replace("L.", "L_"), {}, names)
    assert smem == names["L_bytes"]
    assert smem == _smem_bytes(N, M, z, E, G, True, code=True, early_stop=True,
                               lut_iters=lut)


@pytest.mark.parametrize("name, shape", [
    (WMAN, (8, 384)), ("802_11n_N648_R56_z27", (4, 256)), ("BCH_63_51", (32, 384)),
    ("Polar_64_48", (32, 256)), ("MACKAY_N96_K48", (32, 256)),
    ("5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640", (8, 768)),
    ("5G_LDPC_R0.73_n_dec2304_n2112_k1536_z72_s1537_1584", (2, 768))])
def test_sp_launch_shape_is_the_fastest_measured(name, shape):
    """SP's fixed-T and syndrome-stop launch shape (G, threads) on each code
    whose every shape was timed on the H100 (`tools/torch_kernel_ab.py
    --kernels sp_shapes`): the fastest of them, with and without UCN."""
    graph = TannerGraph(get_code(name))
    for ucn in (False, True):
        for deploy in (False, True):
            assert launch_shape(graph, ucn, deploy, False, False, True) == shape


@pytest.mark.parametrize("deg", [1, 2, 6, 14, 15, 16, 17, 22, 28, 32, 33, 64])
def test_sp_check_update_two_passes_equal_the_per_slot_arrays(deg):
    """SP's check update as the kernel forms it (a reverse pass that derives
    each slot's tanh and accumulates the suffix products a chunk of
    kSPRegDeg slots at a time, keeping chunk 0's and the running product at
    each chunk's top, then a forward pass that forms a later chunk's suffix
    products again from its top's product and its own slots) against the
    three passes over per-slot arrays that it replaced, op for op in
    float32: every C->V message bit-equal, for the check degrees of the
    bundled codes (MacKay 6, wman 14 and 15, 802.11n 22, BCH 28, Polar 64)
    and either side of a chunk's bound."""
    reg = _cuh_constant("kSPRegDeg")
    assert deg <= _cuh_constant("kMaxDegSP")
    rng = np.random.default_rng(deg)
    R = 3000
    x = rng.normal(0.0, 4.0, (R, deg)).astype(np.float32)
    x[: R // 5] = rng.integers(-1, 2, (R // 5, deg)) * np.float32(1e-8)  # zeros
    x[R // 5: R // 3] *= np.float32(10.0)  # saturated tanh: clipped products
    x = torch.from_numpy(x)
    clip = np.float32(1.0 - 1e-7)

    def tanh_slot(j):
        v = torch.tanh(np.float32(-0.5) * x[:, j])
        return torch.where(v == 0.0, torch.ones_like(v), v)

    def out_of(prod):
        return np.float32(-2.0) * torch.atanh(torch.clamp(prod, -clip, clip))

    # the per-slot arrays: tanh forward, suffix products reverse, outputs forward
    v = [tanh_slot(j) for j in range(deg)]
    acc, suf = torch.ones(R), [None] * deg
    for q in range(deg - 1, -1, -1):
        suf[q] = acc
        acc = v[q] if q == deg - 1 else acc * v[q]
    pre, ref = torch.ones(R), []
    for q in range(deg):
        ref.append(out_of(suf[0] if q == 0 else (pre if q == deg - 1 else pre * suf[q])))
        pre = v[q] if q == 0 else pre * v[q]
    # the kernel's two passes, a chunk of `reg` slots at a time
    slots, regs, top = [None] * deg, [None] * reg, {}
    acc = torch.ones(R)
    for c in range((deg - 1) // reg, -1, -1):
        top[c] = acc
        for i in range(reg - 1, -1, -1):
            j = c * reg + i
            if j < deg:
                slots[j] = tanh_slot(j)
                regs[i] = acc
                acc = slots[j] if j == deg - 1 else acc * slots[j]
    pre, got = torch.ones(R), []
    for c in range(-(-deg // reg)):
        if c > 0:  # the chunk's suffix products again, from its top
            s = top[c]
            for i in range(reg - 1, -1, -1):
                j = c * reg + i
                if j < deg:
                    regs[i] = s
                    s = slots[j] if j == deg - 1 else s * slots[j]
        for i in range(reg):
            j = c * reg + i
            if j < deg:
                s = regs[i]
                got.append(out_of(s if j == 0 else (pre if j == deg - 1 else pre * s)))
                pre = slots[j] if j == 0 else pre * slots[j]
    assert torch.equal(_bits(torch.stack(got)), _bits(torch.stack(ref)))


def _sp_clip_tanh_input() -> np.float32:
    """A float32 x whose float32 tanh is exactly kSPClip (1 - 2^-23): a
    product of it and saturated slots (tanh 1.0) hits the product clip."""
    clip = np.float32(1.0 - 1e-7)
    for k in range(4000):
        x = np.float32(8.30 + 1e-5 * k)
        if torch.tanh(torch.tensor(x)).item() == clip:
            return x
    raise AssertionError("no input whose tanh is the SP clip")


@pytest.mark.parametrize("deg", [1, 2, 6, 14, 15, 16, 17, 22, 28, 32, 33, 64])
def test_sp_check_backward_in_chunks_equals_the_per_slot_arrays(deg):
    """B5-SP's check backward as the kernel forms it (csrc/fused_nms_train.cu
    `sp_check_bwd`: a reverse pass that replaces each slot's pre-clip message
    with its raw tanh and accumulates the suffix products a chunk of
    kSPRegDeg slots at a time in registers, keeping the running product at
    each earlier chunk's top; a forward pass that forms a later chunk's
    suffix products again from its top, runs the product clip, atanh and
    the weighting chain and its gradient, and leaves the last chunk's gF =
    g_p*B in registers and an earlier chunk's g_p in gc, keeping the prefix
    product and the running gB at each chunk's bottom; then, chunk by chunk
    from the last, an earlier chunk's gF and shares formed again, a reverse
    pass that keeps in each slot's register the running gF above it, and a
    forward pass that forms the prefix products again and runs the share,
    tanh's derivative and the clip mask) against the four passes over
    per-slot arrays it replaced, op for op in float32: every slot's
    cotangent and per-slot CN-weight gradient bit-equal, under scale and
    offset weights, for the check degrees of the bundled codes and either
    side of a chunk's bound, with zero messages, saturated ones and products
    that hit the product clip exactly."""
    reg = _cuh_constant("kSPRegDeg")
    assert deg <= _cuh_constant("kMaxDegSP")
    f32 = np.float32
    clip_llr, spclip = f32(20.0), f32(1.0 - 1e-7)
    rng = np.random.default_rng(100 + deg)
    R = 2000
    pre = rng.normal(0.0, 6.0, (R, deg)).astype(np.float32)
    pre[: R // 8] = 0.0  # zero messages: tanh 0, the product's zero->1 map
    pre[R // 8: R // 4] *= f32(8.0)  # saturated: clipped messages, tanh +-1
    x0 = _sp_clip_tanh_input()
    hit = np.arange(R // 4, R // 3)  # tanh 1.0, and one slot's tanh is the clip:
    pre[hit] = f32(-40.0)  # the others' products hit it
    pre[hit, rng.integers(0, deg, hit.size)] = -2.0 * x0
    pre = torch.from_numpy(pre)
    gin = torch.from_numpy(rng.normal(0.0, 1.0, (R, deg)).astype(np.float32))
    w = torch.from_numpy((0.2 + rng.random((R, deg))).astype(np.float32))
    tt_of = lambda v: torch.where(v == 0.0, torch.ones_like(v), v)
    hits = 0
    for offset in (False, True):
        def chain(F, Bn, n, g_in_c):
            """slot n's product clip, atanh, weighting chain and its gradient:
            (g_p, the per-slot weight gradient), as both orders write it"""
            p = F * Bn
            pc = torch.clamp(p, -spclip, spclip)
            out = f32(-2.0) * torch.atanh(pc)
            mag = out.abs()
            so = torch.sign(out)
            r = mag - w[:, n] if offset else mag * w[:, n]
            g_in = torch.where((r > 0.0) & (r <= clip_llr), g_in_c * so, torch.zeros_like(r))
            g_mag = g_in if offset else g_in * w[:, n]
            gwv = -g_in if offset else g_in * mag
            g_out = g_mag * torch.where(out >= 0.0, 1.0, -1.0)
            g_pc = g_out * (f32(-2.0) / (1.0 - pc * pc))
            in_hi = f32(0.5) * ((p < spclip).float() + (p <= spclip).float())
            in_lo = f32(0.5) * ((p > -spclip).float() + (p >= -spclip).float())
            return g_pc * in_hi * in_lo, gwv, int((p.abs() == spclip).sum())

        def final(share, gc_n, raw, inside):
            g_x = (share + gc_n) * f32(-0.5) * (1.0 - raw * raw)
            return torch.where(inside, g_x, torch.zeros_like(g_x))

        inside = pre.abs() <= clip_llr
        # the per-slot arrays (four passes), as the kernel's earlier form wrote them
        ttr, fp, bs = [None] * deg, [None] * deg, [None] * deg
        a = torch.ones(R)
        for n in range(deg):
            ttr[n] = torch.tanh(f32(-0.5) * torch.clamp(pre[:, n], -clip_llr, clip_llr))
            fp[n] = a
            a = tt_of(ttr[n]) if n == 0 else a * tt_of(ttr[n])
        a = torch.ones(R)
        for n in range(deg - 1, -1, -1):
            bs[n] = a
            a = tt_of(ttr[n]) if n == deg - 1 else a * tt_of(ttr[n])
        gc, gw_ref = gin.clone(), [None] * deg
        gb = torch.zeros(R)
        for n in range(deg):
            g_p, gw_ref[n], h = chain(fp[n], bs[n], n, gc[:, n])
            hits += h
            Bn = bs[n]
            bs[n] = g_p * Bn
            gbn = g_p * fp[n]
            share = torch.zeros(R)
            if n == 0:
                gb = gbn
            else:
                share = gb * Bn
                gb = gbn + gb * tt_of(ttr[n])
            gc[:, n] = share
        gf = torch.zeros(R)
        for n in range(deg - 1, -1, -1):
            share = torch.zeros(R)
            if n == deg - 1:
                gf = bs[n]
            else:
                share = gf * fp[n]
                gf = bs[n] + gf * tt_of(ttr[n])
            gc[:, n] = final(share, gc[:, n], ttr[n], inside[:, n])
        ref_gc, ref_gw = gc, torch.stack(gw_ref, 1)

        # the kernel's passes, a chunk of `reg` slots at a time
        ts, gc = pre.clone(), gin.clone()  # the staged run, the cotangents
        gw = torch.zeros(R, deg)
        C = (deg - 1) // reg
        bq, top, bot, gbot = [None] * reg, {}, {}, {}
        acc = torch.ones(R)
        for cc in range(C, -1, -1):  # A: reverse
            if cc < C:
                top[cc] = acc
            for ii in range(reg - 1, -1, -1):
                j = cc * reg + ii
                if j < deg:
                    v = torch.tanh(f32(-0.5) * torch.clamp(ts[:, j], -clip_llr, clip_llr))
                    ts[:, j] = v
                    bq[ii] = acc
                    acc = tt_of(v) if j == deg - 1 else acc * tt_of(v)
        a, gb = torch.ones(R), torch.zeros(R)
        for cc in range(C + 1):  # B: forward
            if cc > 0:
                bot[cc], gbot[cc] = a, gb
                s = top[cc] if cc < C else torch.ones(R)
                for ii in range(reg - 1, -1, -1):
                    j = cc * reg + ii
                    if j < deg:
                        v = tt_of(ts[:, j])
                        bq[ii] = s
                        s = v if j == deg - 1 else s * v
            for ii in range(reg):
                j = cc * reg + ii
                if j < deg:
                    tv = tt_of(ts[:, j])
                    F, Bn = a, bq[ii]
                    a = tv if j == 0 else a * tv
                    g_p, gw[:, j], _ = chain(F, Bn, j, gc[:, j])
                    gbn = g_p * F
                    share = torch.zeros(R)
                    if j == 0:
                        gb = gbn
                    else:
                        share = gb * Bn
                        gb = gbn + gb * tv
                    bq[ii] = g_p * Bn
                    gc[:, j] = share if cc == C else g_p
        gf = torch.zeros(R)
        for cc in range(C, -1, -1):  # C: per chunk, last to first
            f0 = bot[cc] if cc > 0 else torch.ones(R)
            if cc < C:  # the chunk's gF and shares again
                s = top[cc]
                for ii in range(reg - 1, -1, -1):
                    j = cc * reg + ii
                    if j < deg:
                        v = tt_of(ts[:, j])
                        bq[ii] = s
                        s = v if j == deg - 1 else s * v
                aa, gg = f0, gbot[cc] if cc > 0 else torch.zeros(R)
                for ii in range(reg):
                    j = cc * reg + ii
                    if j < deg:
                        tv = tt_of(ts[:, j])
                        F, Bn, g_p = aa, bq[ii], gc[:, j].clone()
                        aa = tv if j == 0 else aa * tv
                        gbn = g_p * F
                        share = torch.zeros(R)
                        if j == 0:
                            gg = gbn
                        else:
                            share = gg * Bn
                            gg = gbn + gg * tv
                        bq[ii] = g_p * Bn
                        gc[:, j] = share
            for ii in range(reg - 1, -1, -1):  # the running gF above each slot
                j = cc * reg + ii
                if j < deg:
                    gF = bq[ii]
                    bq[ii] = gf
                    gf = gF if j == deg - 1 else gF + gf * tt_of(ts[:, j])
            aa = f0
            for ii in range(reg):  # F again, the share gF*F, the derivative
                j = cc * reg + ii
                if j < deg:
                    raw = ts[:, j]
                    share = torch.zeros(R) if j == deg - 1 else bq[ii] * aa
                    aa = tt_of(raw) if j == 0 else aa * tt_of(raw)
                    gc[:, j] = final(share, gc[:, j], raw, inside[:, j])
        assert torch.equal(_bits(gc), _bits(ref_gc)), offset
        assert torch.equal(_bits(gw), _bits(ref_gw)), offset
        assert bool((ref_gc != 0).any()) or deg == 1
    assert deg == 1 or hits > 0  # the product clip was hit exactly


def _cu_functions(src: str) -> dict:
    """The straight-line C++ of csrc/fused_nms_train.cu's `Cfg::cn_sum`,
    `vn_sum`, `R` and the `BwdLayout` constructor, as Python source (a
    conditional `a ? b : c` at most once per statement, `&&`, `||`)."""
    def expr(e: str) -> str:
        e = e.replace("&&", " and ").replace("||", " or ")
        m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", e)
        return f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))" if m else e

    out = {}
    for name, pat in (("cn_sum", r"int cn_sum\(\) const \{(.*?)\n  \}"),
                      ("vn_sum", r"int vn_sum\(\) const \{(.*?)\n  \}"),
                      ("R", r"int R\(bool sp\) const \{(.*?)\n  \}"),
                      ("layout", r"BwdLayout\(const Cfg& c, bool sp\) \{(.*?)\n  \}")):
        body = re.search(pat, src, re.S).group(1)
        lines = []
        for stmt in (t.strip() for t in body.split(";") if t.strip()):
            if m := re.fullmatch(r"if \((.+)\) return (.+)", stmt, re.S):
                lines.append(f"if {expr(m.group(1))}: return {expr(m.group(2))}")
            elif m := re.fullmatch(r"return (.+)", stmt, re.S):
                lines.append(f"return {expr(m.group(1))}")
            elif m := re.fullmatch(r"(?:const )?int (.+)", stmt, re.S):
                # declarators split at the commas outside parentheses
                parts, depth, cur = [], 0, ""
                for ch in m.group(1):
                    depth += (ch == "(") - (ch == ")")
                    if ch == "," and depth == 0:
                        parts, cur = parts + [cur], ""
                    else:
                        cur += ch
                lines += [f"{a.split('=')[0].strip()} = {expr(a.split('=', 1)[1])}"
                          for a in parts + [cur]]
            elif m := re.fullmatch(r"(\w+) (\+?=) (.+)", stmt, re.S):
                lines.append(f"{m.group(1)} {m.group(2)} {expr(m.group(3))}")
            else:
                raise AssertionError(f"untranslated statement: {stmt}")
        out[name] = "\n".join(lines)
    return out


@pytest.mark.parametrize("sp", [False, True])
def test_bwd_shared_memory_equals_the_kernel_layout(sp):
    """`_smem_bwd` against csrc/fused_nms_train.cu's `BwdLayout` (translated
    from the source) for every weight-sum strategy of B5 and B5-SP (no
    weights, per-slot, per-bit, per-item, in registers), with and without
    UCN, on codes of odd and even E*z, at every G."""
    src = (Path(fused_decoder.__file__).parent.parent / "csrc" /
           "fused_nms_train.cu").read_text()
    fns = _cu_functions(src)
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}

    def method(name, cfg):
        def f(*args):
            env = {**consts, **vars(cfg), "sp": args[0] if args else None}
            exec("def _f():\n" + "\n".join("    " + ln for ln in fns[name].splitlines()), env)
            return env["_f"]()
        return f

    for name in (WMAN, "802_11n_N648_R56_z27", "MACKAY_N96_K48", "Polar_64_48"):
        graph = TannerGraph(get_code(name))
        code = graph.code
        for sharing in ((3, 3, 3), (3, 0, 3), (2, 2, 2), (1, 1, 0), (5, 0, 5), (4, 4, 0),
                        (0, 0, 0), (0, 0, 2)):
            spec = WeightSpec(sharing=sharing, n_iters=2, fixed_iter=1)
            for G in (1, 2, 4, 8, 16, 32):
                cfg = type("Cfg", (), {})()
                cfg.__dict__.update(N=code.N, M=code.M, z=code.z, E=graph.E, G=G,
                                    dim_cn=spec.dim("cn", graph), dim_vn=spec.dim("vn", graph),
                                    cn_mode=sharing[0], vn_mode=sharing[2],
                                    ucn=int(spec.ucn_enabled))
                for m in ("cn_sum", "vn_sum", "R"):
                    setattr(cfg, m, method(m, cfg))
                env = {**consts, "c": cfg, "sp": sp,
                       "table_bytes": lambda N, M, E: _table_bytes(N, M, E)}
                exec(fns["layout"], env)
                assert env["end"] == _smem_bwd(graph, spec, G, sp), (name, sharing, G)
                assert env["stage"] % 16 == 0  # the bulk copy's destination


@pytest.mark.parametrize("name, fwd, bwd", [
    (WMAN, (8, 384), (8, 768)), ("802_11n_N648_R56_z27", (4, 576), (4, 576)),
    ("MACKAY_N96_K48", (32, 256), (32, 384))])
def test_sp_train_launch_shapes_are_the_fastest_measured(name, fwd, bwd):
    """B4-SP's and B5-SP's launch shapes (G, threads) on each code whose every
    shape was timed on the H100 (`tools/torch_kernel_ab.py --kernels
    sp_train_shapes`, the neural BP base block at batch 32768): the fastest
    of them, or within 1.6% of it, with and without UCN."""
    graph = TannerGraph(get_code(name))
    for sharing in ((3, 0, 3), (3, 3, 3)):
        spec = WeightSpec(sharing=sharing, n_iters=2)
        assert train_launch_shape(graph, spec, False, sp=True)[:2] == fwd
        assert train_launch_shape(graph, spec, True, sp=True)[:2] == bwd

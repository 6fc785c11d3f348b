"""The port's differentiable decode (`collect='apps'`, the plain version of
the CUDA pair B4/B5) against the JAX scan backend on identical inputs made
with numpy.

Forward: the APP stack, full and windowed to the last iteration
(``app_t0 = T-1``); QMS bit-equal (==), MS and MS_RAW within atol 1e-5.
Loss and gradients against `jax.value_and_grad` through the JAX scan
decoder: each kind's gradient within rtol 5e-5 and atol 5e-6 x max|g| (the
tolerances the JAX package holds its own fused pair to); the soft-FER loss
(a mean over words) within rtol 1e-6, the BCE and soft-BER losses (means
over every bit of every word) within rtol 5e-6: XLA's float32 mean over the
4 x 576 x 32 values of the soft-BER case is itself 1.4e-6 (relative) off
its float64 value, torch's 1e-7.  SP (neural BP: the plain version of the
card's B4-SP/B5-SP) is held at atol 1e-4 on the APPs (torch's tanh and
atanh are not XLA's) in the JAX package's two SP cases and the per-edge
branch of its SP backward.  The extrinsic min's tie-splitting backward
is exact against the JAX package's `_ext_min_vjp_bwd`.
"""

import types

import jax
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
from ldpc_error_floor_tpu.models.nms import _ext_min_vjp_bwd
from ldpc_error_floor_tpu.training.losses import \
    multi_iteration_loss as jax_loss
from ldpc_error_floor_tpu_torch.codes import TannerGraph, available_codes, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, params_from_numpy)
from ldpc_error_floor_tpu_torch.ops.fused_decoder import (_SMEM_LIMIT,
                                                          _SMEM_PER_SM,
                                                          _SMEM_RESERVED,
                                                          _SP_THREADS,
                                                          _SP_WARPS_PER_SM,
                                                          _TWO_BLOCK_THREADS,
                                                          _ExtMin,
                                                          _graph_table,
                                                          _smem_bytes,
                                                          check_sp_degree,
                                                          ext_min_bwd,
                                                          launch_shape,
                                                          sp_launch_shape)
from ldpc_error_floor_tpu_torch.ops.fused_train import (FusedTrainKernel,
                                                        _smem_bwd,
                                                        _train_table,
                                                        train_launch_shape)
from ldpc_error_floor_tpu_torch.training.losses import multi_iteration_loss

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"
MACKAY = "MACKAY_N96_K48"

# (id, code, sharing, decoding_type, T, loss_type, etha, neural_mode,
#  systematic): the JAX package's fused-train parity cases
#  (tests/test_pallas_train.py CASES) at T <= 4
CASES = [
    ("wman_303_qms_softfer_eta05", WMAN, (3, 0, 3), 2, 3, 2, 0.5, "scale", 0),
    ("wman_333_qms_ucn_eta0", WMAN, (3, 3, 3), 2, 3, 2, 0.0, "scale", 0),
    ("wman_505_qms_temporal_softber", WMAN, (5, 0, 5), 2, 4, 1, 0.8, "scale", 0),
    ("wman_110_qms_per_edge_bce", WMAN, (1, 1, 0), 2, 2, 0, 1.0, "scale", 0),
    ("wman_222_ms", WMAN, (2, 2, 2), 1, 3, 2, 0.5, "scale", 0),
    ("wman_303_qms_offset", WMAN, (3, 0, 3), 2, 3, 2, 0.5, "offset", 0),
    ("5g_222_qms_systematic", G5, (2, 2, 2), 2, 3, 2, 0.5, "scale", 1),
    ("mackay_303_ms_raw", MACKAY, (3, 0, 3), 3, 3, 2, 0.5, "scale", 0),
    ("wman_303_sp_softfer_eta05", WMAN, (3, 0, 3), 0, 3, 2, 0.5, "scale", 0),
    ("wman_222_sp_ucn_softber_eta08", WMAN, (2, 2, 2), 0, 3, 1, 0.8, "scale", 0),
    ("wman_110_sp_per_edge_bce", WMAN, (1, 1, 0), 0, 2, 0, 1.0, "scale", 0),
]
# rtol beside the APP atol: one value of the UCN SP case's 55,296 misses
# atol 1e-4, by 1.0014e-4 at |APP| 12.94 (7.7e-6 relative): torch's tanh and
# atanh are not XLA's, and atanh's slope near the product clip magnifies the
# difference
APP_RTOL = {"wman_222_sp_ucn_softber_eta08": 1e-5}


def _inputs(code_name, sharing, dec, T, mode, B=32, seed=5):
    """numpy weights and LLRs (formed by the JAX channel from numpy noise)."""
    rng = np.random.default_rng(seed)
    jcode = jax_get_code(code_name)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=sharing, n_iters=T)
    params = {}
    for kind in ("cn", "ucn", "vn"):
        d = jspec.dim(kind, jgraph)
        lo, hi = (0.0, 0.6) if mode == "offset" and kind != "vn" else (0.7, 1.3)
        params[kind] = None if d == 0 else rng.uniform(
            lo, hi, (jspec.n_rows(kind), d)).astype(np.float32)
    sigma = np.full((B,), np.float32(jcode.snr_sigmas([2.5])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((jcode.n_full, B)) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode, decoding_type=dec, q_bit=5)._llr(
        jnp.asarray(y), jnp.asarray(sigma)))
    return jcode, jgraph, jspec, params, llr


def _decoders(case, app_t0=0):
    (_, code_name, sharing, dec, T, _, _, mode, systematic) = case
    jcode, jgraph, jspec, params, llr = _inputs(code_name, sharing, dec, T, mode)
    target = (jcode.N - jcode.M) if systematic else 0
    kw = dict(decoding_type=dec, q_bit=5, neural_mode=mode, target_node=target)
    jdec = JaxDecoder(jcode, JaxConfig(**kw), jspec, graph=jgraph)
    code = get_code(code_name)
    tdec = NMSDecoder(code, DecoderConfig(**kw, app_t0=app_t0),
                      WeightSpec(sharing=sharing, n_iters=T),
                      graph=TannerGraph(code), device="cpu")
    return jdec, tdec, params, llr


def _jparams(params):
    return {k: None if v is None else jnp.asarray(v) for k, v in params.items()}


def _assert_apps(apps, ref, dec, rtol=0.0):
    assert apps.shape == ref.shape
    if dec == 2:
        np.testing.assert_array_equal(apps, ref)
    else:
        np.testing.assert_allclose(apps, ref, rtol=rtol,
                                   atol=1e-4 if dec == 0 else 1e-5)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apps_match_jax_scan(case):
    dec = case[3]
    jdec, tdec, params, llr = _decoders(case)
    ref = np.asarray(jdec.decode(_jparams(params), jnp.asarray(llr),
                                 collect="apps").apps)
    res = tdec.apply(params_from_numpy(params, "cpu"), torch.from_numpy(llr),
                     collect="apps")
    assert not tdec.train_kernel.launches  # CPU tensors take the plain version
    _assert_apps(res.apps.numpy(), ref, dec, rtol=APP_RTOL.get(case[0], 0.0))
    # app_last is the last APP over every bit; its target rows are apps[-1]
    assert res.app_last.shape == (tdec.N * tdec.z, llr.shape[1])
    np.testing.assert_array_equal(res.app_last[: tdec.target * tdec.z].numpy(),
                                  res.apps[-1].numpy())
    # the emission window of the static eta = 0 loss: the last iteration only
    T = ref.shape[0]
    _, tdec_w, _, _ = _decoders(case, app_t0=T - 1)
    win = tdec_w.apply(params_from_numpy(params, "cpu"), torch.from_numpy(llr),
                       collect="apps").apps
    assert win.shape[0] == 1
    np.testing.assert_array_equal(win[0].numpy(), res.apps[-1].numpy())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_and_gradients_match_jax_scan(case):
    (_, _, _, dec, T, loss_type, etha, _, _) = case
    jdec, tdec, params, llr = _decoders(case)
    labels = np.zeros((tdec.target * tdec.z, llr.shape[1]), np.float32)

    def jloss(p):
        res = jdec.apply(p, jnp.asarray(llr), labels=jnp.asarray(labels),
                         collect="apps")
        return jax_loss(res.apps, jnp.asarray(labels), loss_type, etha)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(_jparams(params))
    tp = params_from_numpy(params, "cpu")
    for v in tp.values():
        if v is not None:
            v.requires_grad_(True)
    apps = tdec.apply(tp, torch.from_numpy(llr), collect="apps").apps
    loss = multi_iteration_loss(apps, torch.from_numpy(labels), loss_type, etha)
    loss.backward()
    assert np.allclose(float(loss.detach()), float(lj),
                       rtol=1e-6 if loss_type == 2 else 5e-6)
    for kind in ("cn", "ucn", "vn"):
        if gj[kind] is None:
            assert tp[kind] is None
            continue
        g_ref = np.asarray(gj[kind])
        scale = max(float(np.abs(g_ref).max()), 1e-8)
        np.testing.assert_allclose(tp[kind].grad.numpy(), g_ref, rtol=5e-5,
                                   atol=5e-6 * scale,
                                   err_msg=f"{kind} gradient (scale {scale:.3e})")
        assert float(tp[kind].grad.abs().max()) > 0.0


def test_windowed_gradients_equal_full_stack():
    """app_t0 = T-1 under the eta = 0 loss: the same loss and gradients as
    the full stack, bit for bit."""
    case = CASES[1]
    _, tdec, params, llr = _decoders(case)
    _, tdec_w, _, _ = _decoders(case, app_t0=case[4] - 1)
    labels = torch.zeros((tdec.target * tdec.z, llr.shape[1]))
    out = []
    for d in (tdec, tdec_w):
        tp = params_from_numpy(params, "cpu")
        for v in tp.values():
            if v is not None:
                v.requires_grad_(True)
        apps = d.apply(tp, torch.from_numpy(llr), collect="apps").apps
        loss = multi_iteration_loss(apps, labels, 2, 0.0)
        loss.backward()
        out.append((float(loss.detach()), {k: v.grad for k, v in tp.items() if v is not None}))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k])


def test_tie_splitting_backward_is_exact():
    """Tie-heavy magnitudes on the QMS grid (with the sentinel of the
    structural pads): the port's extrinsic-min backward equals the JAX
    package's `_ext_min_vjp_bwd` exactly, and autograd reaches it.  The
    cotangents are multiples of 1/8, so every sum of them is exact in any
    order and the comparison tests the splitting rule alone."""
    rng = np.random.default_rng(0)
    amag = (0.5 * rng.integers(1, 5, (7, 6, 3, 5))).astype(np.float32)
    amag[0, :, 0, 0] = 1.0                     # all tied
    amag[1, :3, 0, 0] = 1.0e4                  # padded slots
    amag[2, :, 1, 1] = [1.5, 0.5, 2.0, 0.5, 0.5, 3.0]
    g = (rng.integers(-16, 17, amag.shape) / 8.0).astype(np.float32)
    (ref,) = _ext_min_vjp_bwd(jnp.asarray(amag), jnp.asarray(g))
    out = ext_min_bwd(torch.from_numpy(amag), torch.from_numpy(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    a = torch.from_numpy(amag).requires_grad_(True)
    _ExtMin.apply(a).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(ref))
    assert (amag == amag.min(axis=1, keepdims=True)).sum(axis=1).max() > 1


@pytest.mark.parametrize("name", available_codes())
def test_train_launch_shape_and_table(name):
    """B4's and B5's launch shapes and graph table for every bundled code
    (the parts of the CUDA path that run on the host); B4-SP's and B5-SP's
    shapes, the ones `sp_launch_shape` picks for their memory (B4-SP's the
    SP decode layout with the lifted slot table) under their launch bounds
    (the SP decode kernel's where every check fits one chunk of 16 slots,
    else the pair's), and B5-SP's staged run a multiple of 16 bytes."""
    code = get_code(name)
    graph = TannerGraph(code)
    N, M, z, E = code.N, code.M, code.z, graph.E

    def two_fit(nbytes):  # two blocks of nbytes share one SM
        return 2 * (nbytes + _SMEM_RESERVED) <= _SMEM_PER_SM

    for sharing in ((3, 3, 3), (1, 1, 2), (3, 0, 0), (0, 0, 0)):
        spec = WeightSpec(sharing=sharing, n_iters=2)
        for backward in (False, True):
            G, threads, smem = train_launch_shape(graph, spec, backward)
            assert G in (1, 2, 4, 8, 16, 32) and threads % 32 == 0
            assert threads % G == 0 and smem <= _SMEM_LIMIT
            # the pair runs two blocks per SM: the most words whose two
            # blocks fit (else whose one block fits), at most the kernels'
            # launch bound of threads
            assert threads <= _TWO_BLOCK_THREADS
            smem_of = ((lambda g: _smem_bwd(graph, spec, g, False)) if backward else
                       (lambda g: _smem_bytes(N, M, z, E, g, spec.ucn_enabled)))
            fits = two_fit if two_fit(smem_of(1)) else (lambda s: s <= _SMEM_LIMIT)
            assert smem == smem_of(G) and fits(smem)
            assert G == 32 or not fits(smem_of(2 * G))
            if not backward:  # B4 lays out its memory as the decode loop does
                assert launch_shape(graph, spec.ucn_enabled)[0] >= G
                continue
            # B5 stages one residual run, a multiple of 16 bytes, into shared
            # memory beside the slot cotangents
            R = 4 if spec.ucn_enabled else 3
            assert E * z * G % 4 == 0 and R * M * z * G % 4 == 0
            assert smem == _smem_bwd(graph, spec, G, False)
            assert smem >= 4 * (2 * E * z + R * M * z) * G
        for backward in (False, True):
            G, threads, smem = train_launch_shape(graph, spec, backward, sp=True)
            smem_of = ((lambda g: _smem_bwd(graph, spec, g, True)) if backward else
                       (lambda g: _smem_bytes(N, M, z, E, g, spec.ucn_enabled, sp=True)))
            # checks of one chunk: SP's bound; past it, the pair's
            wide = graph.Dc > 16
            top, warps = ((_TWO_BLOCK_THREADS, 2 * _TWO_BLOCK_THREADS // 32) if wide else
                          (_SP_THREADS, _SP_WARPS_PER_SM))
            assert (G, threads) == sp_launch_shape(graph, smem_of, top, warps,
                                                   two_blocks_first=not backward or wide)
            assert smem == smem_of(G) <= _SMEM_LIMIT
            assert threads % G == 0 and threads % 32 == 0 and threads <= top
            if backward:  # the lifted slot table; the staged run: hist and
                R = 1 if spec.ucn_enabled else 0  # (with UCN) the UCN masks; gc
                assert E * z * G % 4 == 0 and R * M * z * G % 4 == 0
                assert smem >= 8 * E * z + 4 * (2 * E * z + R * M * z) * G
    tab = _train_table(graph)
    assert tab.dtype == np.int32 and tab.shape == (4 * E + N + M + 2 + 2 * E,)
    np.testing.assert_array_equal(tab[:-2 * E], _graph_table(graph))
    np.testing.assert_array_equal(tab[-2 * E:-E], graph.edge_cn)
    np.testing.assert_array_equal(tab[-E:], graph.edge_shift % z)


def test_train_kernel_build_and_window_checks(monkeypatch, tmp_path):
    from ldpc_error_floor_tpu_torch.ops import fused_decoder, fused_train
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    with pytest.raises(ValueError, match="app_t0"):
        FusedTrainKernel(graph, DecoderConfig(app_t0=3), spec)
    # the check residuals B4 streams: min-sum 3 (4 with UCN), SP the UCN
    # mask alone (none without UCN)
    ucn = WeightSpec(sharing=(3, 3, 3), n_iters=3)
    rows = {(dec, s.ucn_enabled): FusedTrainKernel(
        graph, DecoderConfig(decoding_type=dec), s).cres_rows
        for dec in (0, 1, 2, 3) for s in (spec, ucn)}
    assert rows == {(0, False): 0, (0, True): 1, (1, False): 3, (1, True): 4,
                    (2, False): 3, (2, True): 4, (3, False): 3, (3, True): 4}
    check_sp_degree(graph)  # the SP kernels' 64-bit clip masks hold 64 slots
    with pytest.raises(ValueError, match="check degrees up to 64"):
        check_sp_degree(types.SimpleNamespace(Dc=65, code=code))
    monkeypatch.setattr(fused_decoder, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    fused_train.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_train.load_library()
    fused_train.load_library.cache_clear()

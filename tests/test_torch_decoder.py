"""The port's decoder (plain PyTorch version on the CPU) against the JAX scan
decoder on identical inputs made with numpy.

QMS cases: error flags and bit-error counts integer-equal, APPs bit-equal
(compared with ==, so -0.0 and 0.0 count as equal).  MS and MS_RAW cases:
counters integer-equal, APPs within atol 1e-4 / rtol 1e-5 (the port sums
C->V messages in slot order; XLA may reduce in another order).  SP:
counters integer-equal on these inputs, APPs within atol 1e-3 / rtol 1e-4
(tanh, atanh and cumprod differ by ulps between XLA and PyTorch, and the
differences grow through the iterations).
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
from ldpc_error_floor_tpu_torch.codes import TannerGraph, available_codes, get_code
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, params_from_numpy)
from ldpc_error_floor_tpu_torch.ops.fused_decoder import (_SMEM_LIMIT,
                                                          FusedNMSKernel,
                                                          _graph_table,
                                                          _smem_bytes,
                                                          _table_bytes,
                                                          launch_shape,
                                                          load_library)

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"

# (id, code, sharing, decoding_type, T, B, neural_mode, weights, target_node,
#  llr_type): weights 'base20' = the bundled set, 'rand' = uniform
#  [0.7, 1.3], 'offset' = CN/UCN offsets uniform [0, 0.6] and VN weights
#  uniform [0.7, 1.3]; llr_type = the channel's
#  decoding type (2 = quantized LLRs, 1 = raw)
CASES = [
    ("slice_wman_333_qms_base20_T20", WMAN, (3, 3, 3), 2, 20, 64, "scale", "base20", 0, 2),
    ("wman_303_qms", WMAN, (3, 0, 3), 2, 5, 32, "scale", "rand", 0, 2),
    ("wman_222_ms", WMAN, (2, 2, 2), 1, 4, 32, "scale", "rand", 0, 1),
    ("wman_100_ms_per_edge", WMAN, (1, 0, 0), 1, 3, 32, "scale", "rand", 0, 1),
    ("wman_445_qms_temporal", WMAN, (4, 4, 5), 2, 5, 32, "scale", "rand", 0, 2),
    ("wman_222_qms_offset", WMAN, (2, 2, 2), 2, 4, 32, "offset", "offset", 0, 2),
    ("wman_303_ms_raw", WMAN, (3, 0, 3), 3, 4, 32, "scale", "rand", 0, 3),
    ("mackay_333_qms_z1", "MACKAY_N96_K48", (3, 3, 3), 2, 4, 32, "scale", "rand", 0, 2),
    ("5g_222_qms_punct_short_target", G5, (2, 2, 2), 2, 3, 32, "scale", "rand", 10, 2),
    ("wman_333_qms_raw_llr", WMAN, (3, 3, 3), 2, 4, 32, "scale", "rand", 0, 1),
    ("wman_303_sp", WMAN, (3, 0, 3), 0, 3, 32, "scale", "rand", 0, 0),
]


def _inputs(code_name, sharing, T, B, weights, llr_type, seed=11):
    """numpy LLRs (formed by the JAX channel from numpy noise) and params."""
    rng = np.random.default_rng(seed)
    jcode = jax_get_code(code_name)
    jgraph = JaxGraph(jcode)
    temporal = any(s in (4, 5) for s in sharing)
    jspec = JaxSpec(sharing=sharing, n_iters=T, fixed_iter=2 if temporal else 0)
    if weights == "base20":
        params = {k: None if v is None else np.asarray(v)
                  for k, v in jax_load_params(jspec, jgraph,
                                              f"{code_name}_base20").items()}
    else:
        params = {}
        for kind in ("cn", "ucn", "vn"):
            d = jspec.dim(kind, jgraph)
            lo, hi = ((0.0, 0.6) if weights == "offset" and kind != "vn"
                      else (0.7, 1.3))
            params[kind] = None if d == 0 else rng.uniform(
                lo, hi, (jspec.n_rows(kind), d)).astype(np.float32)
    sigma = np.full((B,), np.float32(jcode.snr_sigmas([2.0])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((jcode.n_full, B)) * sigma).astype(np.float32)
    chan = JaxChannel(jcode, decoding_type=llr_type, q_bit=5)
    llr = np.array(chan._llr(jnp.asarray(y), jnp.asarray(sigma)))
    return jcode, jgraph, jspec, params, llr


def _decode_both(case):
    (_, code_name, sharing, dec, T, B, mode, weights, target, llr_type) = case
    jcode, jgraph, jspec, params, llr = _inputs(code_name, sharing, T, B,
                                                weights, llr_type)
    jcfg = JaxConfig(decoding_type=dec, q_bit=5, neural_mode=mode,
                     target_node=target)
    ref = JaxDecoder(jcode, jcfg, jspec, graph=jgraph).decode(
        {k: None if v is None else jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(llr), collect="stats")
    code = get_code(code_name)
    spec = WeightSpec(sharing=sharing, n_iters=T, fixed_iter=jspec.fixed_iter)
    cfg = DecoderConfig(decoding_type=dec, q_bit=5, neural_mode=mode,
                        target_node=target)
    dec_t = NMSDecoder(code, cfg, spec, graph=TannerGraph(code), device="cpu")
    res = dec_t.apply(params_from_numpy(params, device="cpu"),
                      torch.from_numpy(llr), collect="stats")
    assert not dec_t.kernel.launches  # CPU tensors take the plain version
    return ref, res


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_decoder_matches_jax_scan(case):
    ref, res = _decode_both(case)
    app_r, err_r, nerr_r = (np.asarray(ref.app_last), np.asarray(ref.err_flags),
                            np.asarray(ref.bit_errors))
    app, err, nerr = (res.app_last.numpy(), res.err_flags.numpy(),
                      res.bit_errors.numpy())
    assert app.shape == app_r.shape and err.shape == err_r.shape
    assert err.dtype == np.bool_ and nerr.dtype == np.int32
    dec = case[3]
    np.testing.assert_array_equal(err, err_r)
    np.testing.assert_array_equal(nerr, nerr_r)
    if dec == 2:
        np.testing.assert_array_equal(app, app_r)
    elif dec == 0:
        np.testing.assert_allclose(app, app_r, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_allclose(app, app_r, rtol=1e-5, atol=1e-4)
    if case[0].startswith("slice"):
        # the slice's case must exercise both decoded and failed words
        uncor = err.all(axis=0)
        assert 0 < uncor.sum() < uncor.size


def test_app_last_collect_and_unported_modes():
    code = get_code(WMAN)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=2)
    dec = NMSDecoder(code, DecoderConfig(), spec, device="cpu")
    params = params_from_numpy({"cn": np.ones((2, 1), np.float32),
                                "vn": np.ones((2, 1), np.float32)}, "cpu")
    llr = -torch.ones((code.n_full, 4))
    res = dec.apply(params, llr, collect="app_last")
    assert res.err_flags is None and res.app_last.shape == (code.n_full, 4)
    # every mode of the JAX decoder is ported now: 'apps' returns the APP
    # stack (training), an unknown mode raises
    res = dec.apply(params, llr, collect="apps")
    assert res.apps.shape == (2, code.n_full, 4)
    assert torch.equal(res.app_last, res.apps[-1])
    with pytest.raises(ValueError, match="collect"):
        dec.apply(params, llr, collect="syndrome")


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = get_code(WMAN)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NMSDecoder(code, DecoderConfig(), spec)  # device defaults to "cuda"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from ldpc_error_floor_tpu_torch.ops import fused_decoder
    monkeypatch.setattr(fused_decoder, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        load_library()
    load_library.cache_clear()


def test_kernel_has_no_sp_branch_yet(monkeypatch, tmp_path):
    """The kernel has an SP branch now: an SP launch passes the wrapper's
    checks and goes on to build the kernel (which needs nvcc)."""
    from ldpc_error_floor_tpu_torch.ops import fused_decoder
    monkeypatch.setattr(fused_decoder, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    load_library.cache_clear()
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(0, 0, 0), n_iters=2)
    kern = FusedNMSKernel(graph, DecoderConfig(decoding_type=0), spec)
    for mode in (fused_decoder.FIXED, fused_decoder.EARLY_STOP,
                 fused_decoder.DEPLOY):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kern._launch({"cn": None, "ucn": None, "vn": None},
                         torch.zeros((code.n_full, 4)), mode)
    load_library.cache_clear()
    assert not kern.launches


@pytest.mark.parametrize("name", available_codes())
def test_launch_shape_and_graph_table(name):
    """The kernel's launch shape and graph table for every bundled code (the
    parts of the CUDA path that run on the host)."""
    code = get_code(name)
    graph = TannerGraph(code)
    for ucn in (False, True):
        for deploy in (False, True):
            G, threads = launch_shape(graph, ucn, deploy)
            assert G in (1, 2, 4, 8, 16, 32) and threads % 32 == 0
            assert threads % G == 0 and threads <= 1024
            smem = _smem_bytes(code.N, code.M, code.z, graph.E, G, ucn, deploy)
            assert smem <= _SMEM_LIMIT
            # the staged table and weights (16-byte aligned), then the [row][G]
            # state: C->V and bit totals, counts, parity bits
            head = _table_bytes(code.N, code.M, graph.E)
            assert head % 16 == 0 and head >= 4 * (4 * graph.E + code.N + code.M + 2)
            head += -(-4 * (2 * graph.E + code.N) // 16) * 16
            assert smem == (head + 4 * (graph.E + code.N) * code.z * G
                            + 4 * (4 if deploy else 2) * G
                            + (code.N * code.z * G if ucn or deploy else 0))
    N, M, E, z = code.N, code.M, graph.E, code.z
    tab = _graph_table(graph)
    assert tab.dtype == np.int32 and tab.shape == (4 * E + N + 1 + M + 1,)
    slots = tab[:4 * E].reshape(E, 4)   # per check-order position q
    vn_ptr, cn_ptr = tab[4 * E:4 * E + N + 1], tab[4 * E + N + 1:]
    cn_edge = slots[:, 3]
    for j in range(N):  # VN j owns a contiguous range of VN-order edges
        assert (graph.edge_vn[vn_ptr[j]:vn_ptr[j + 1]] == j).all()
    for i in range(M):  # check i lists its edges in CN order
        edges = cn_edge[cn_ptr[i]:cn_ptr[i + 1]]
        assert (graph.edge_cn[edges] == i).all()
        np.testing.assert_array_equal(graph.cn_order_of_edge[edges],
                                      np.arange(cn_ptr[i], cn_ptr[i + 1]))
    np.testing.assert_array_equal(slots[:, 0], cn_edge * z)
    np.testing.assert_array_equal(slots[:, 1], graph.edge_vn[cn_edge] * z)
    np.testing.assert_array_equal(slots[:, 2], graph.edge_shift[cn_edge] % z)
    assert ((slots[:, 2] >= 0) & (slots[:, 2] < z)).all()

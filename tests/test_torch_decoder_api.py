"""The decoder's public API against the JAX package's, on the CPU:
`decode(labels=...)` (stats, deploy, the genie early stop, systematic
targets), `DecoderConfig.track_syndrome` / `DecodeResult.syndrome_ok`,
`apply`'s default ``collect='apps'`` and its `app_last` under a systematic
target (the scan's carry: the last APP over every bit, and its gradient),
`BoostedDecoder.decode(labels=...)` and `codes.save_proto_json`.

Inputs are real codewords: numpy messages encoded by both packages'
`Encoder.encode` (equal), sent as BPSK over numpy noise and turned into LLRs
by the JAX channel (`_llr`: QMS quantization, SP's +0.001 on punctured bits).
Each JAX function runs through its scan backend.

Tolerances: error flags, bit-error counts and deploy's wrong / bit_errors /
iters / detected_fail integer-equal, syndrome flags bool-equal; APPs within
atol 1e-4 + rtol 1e-5 (the port sums C->V messages in slot order, XLA may
reduce in another order; SP's tanh/atanh are not XLA's); gradients within
rtol 5e-5 and atol 5e-6 x max|g| (as `tests/test_torch_train_grad.py`);
`save_proto_json` byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.codes import Encoder as JaxEncoder
from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.codes import load_proto_matrix as jax_load_proto
from ldpc_error_floor_tpu.codes import save_proto_json as jax_save_proto_json
from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.models.boosted import BoostedDecoder as JaxBoosted
from ldpc_error_floor_tpu_torch.codes import (Encoder, TannerGraph, get_code,
                                              load_proto_matrix, save_proto_json)
from ldpc_error_floor_tpu_torch.models import (BoostedDecoder, DecoderConfig,
                                               NMSDecoder, WeightSpec,
                                               init_weights, params_from_numpy)

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
MACKAY = "MACKAY_N96_K48"
WMAN_PUNCT = (1, 48)  # wman's first 2z systematic bits punctured, as in 5G
APP_TOL = dict(rtol=1e-5, atol=1e-4)


def _inputs(name, sharing, dec, snr, T, B, seed, punct=None):
    """(JAX code and graph, port code and graph, numpy weights in
    [0.7, 1.3], codeword bits [n_full, B], LLRs [n_full, B])."""
    rng = np.random.default_rng(seed)
    jcode, code = jax_get_code(name, punct=punct), get_code(name, punct=punct)
    jgraph, graph = JaxGraph(jcode), TannerGraph(code)
    jenc, enc = JaxEncoder(jgraph), Encoder(graph, device="cpu")
    assert jenc.k == enc.k
    msgs = rng.integers(0, 2, (enc.k, B)).astype(np.float32)
    bits = np.array(jenc.encode(jnp.asarray(msgs)))
    np.testing.assert_array_equal(enc.encode(torch.from_numpy(msgs)).numpy(), bits)
    assert bits.any() and not ((graph.H.astype(np.int64) @ bits.astype(np.int64)) % 2).any()
    spec = WeightSpec(sharing=sharing, n_iters=T)
    params = {k: None if spec.dim(k, graph) == 0 else
              rng.uniform(0.7, 1.3, (spec.n_rows(k), spec.dim(k, graph))).astype(np.float32)
              for k in ("cn", "ucn", "vn")}
    sigma = np.full((B,), np.float32(code.snr_sigmas([snr])[0]), np.float32)
    y = ((2.0 * bits - 1.0) + rng.standard_normal(bits.shape) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode, decoding_type=dec, q_bit=5)._llr(
        jnp.asarray(y), jnp.asarray(sigma)))
    return jcode, jgraph, code, graph, params, bits, llr


def _jax(params):
    return {k: None if v is None else jnp.asarray(v) for k, v in params.items()}


# (id, code, puncture, sharing, decoding type, SNR dB, T, target_node,
#  collect, track_syndrome); B = 48.  SP's APPs drift from XLA's once a
#  word converges and tanh saturates (float32 tanh/atanh differ in the
#  last ulps, and atanh near +-1 amplifies that: 0.14 at 3 dB, T = 5, on
#  wman unpunctured), so its case runs at 2 dB, where one word converges
#  and the APPs agree to 4e-5
LABEL_CASES = [
    ("qms_stats", WMAN, None, (3, 3, 3), 2, 3.0, 6, 0, "stats", True),
    ("ms_stats_systematic", MACKAY, None, (3, 0, 3), 1, 2.5, 6, 48, "stats", False),
    ("sp_punct_stats", WMAN, WMAN_PUNCT, (3, 0, 3), 0, 2.0, 8, 0, "stats", True),
    ("qms_deploy", WMAN, None, (3, 0, 3), 2, 3.25, 6, 0, "deploy", False),
]


@pytest.mark.parametrize("case", LABEL_CASES, ids=[c[0] for c in LABEL_CASES])
def test_labels_match_jax_scan(case):
    """`decode(labels=codewords)` on the plain path: counters integer-equal
    to JAX's scan with the same labels, APPs within tolerance, and under
    ``track_syndrome`` the syndrome flags bool-equal."""
    _, name, punct, sharing, dec, snr, T, target, collect, track = case
    jcode, jgraph, code, graph, params, bits, llr = _inputs(
        name, sharing, dec, snr, T, 48, seed=11, punct=punct)
    labels = bits[: (target or code.N) * code.z]
    ref = JaxDecoder(jcode, JaxConfig(decoding_type=dec, q_bit=5, target_node=target,
                                      track_syndrome=track),
                     JaxSpec(sharing=sharing, n_iters=T), graph=jgraph).decode(
        _jax(params), jnp.asarray(llr), labels=jnp.asarray(labels), collect=collect)
    dec_t = NMSDecoder(code, DecoderConfig(decoding_type=dec, q_bit=5, target_node=target,
                                           track_syndrome=track),
                       WeightSpec(sharing=sharing, n_iters=T), graph=graph, device="cpu")
    res = dec_t.decode(params_from_numpy(params, device="cpu"), torch.from_numpy(llr),
                       labels=torch.from_numpy(labels), collect=collect)
    if collect == "deploy":
        for field in ("wrong", "bit_errors", "iters", "detected_fail"):
            np.testing.assert_array_equal(getattr(res, field).numpy(),
                                          np.asarray(getattr(ref, field)), err_msg=field)
        np.testing.assert_allclose(res.app.numpy(), np.asarray(ref.app), **APP_TOL)
        assert 0 < int(res.wrong.sum()) < 48
        return
    np.testing.assert_array_equal(res.err_flags.numpy(), np.asarray(ref.err_flags))
    np.testing.assert_array_equal(res.bit_errors.numpy(), np.asarray(ref.bit_errors))
    np.testing.assert_allclose(res.app_last.numpy(), np.asarray(ref.app_last), **APP_TOL)
    if track:
        np.testing.assert_array_equal(res.syndrome_ok.numpy(), np.asarray(ref.syndrome_ok))
        assert res.syndrome_ok.shape == (T, 48) and bool(res.syndrome_ok[-1].any())
    else:
        assert res.syndrome_ok is None
    # the labels matter: some words decode, some fail, against real codewords
    assert 0 < int(res.err_flags[-1].sum()) < 48


def test_labels_under_early_stop_equal_the_sign_fold():
    """MS, plain path, genie early stop: decoding y against its codeword
    equals decoding the sign-folded y against the zero word (exact for a
    continuous channel, as JAX's `tests/test_encoder.py` holds its scan),
    and the genie-failure mask is the fixed-T labelled decode's."""
    _, _, code, graph, params, bits, llr = _inputs(MACKAY, (3, 0, 3), 1, 4.0, 6, 128, seed=1)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=6)
    p = params_from_numpy(params, device="cpu")
    x, lab = torch.from_numpy(llr), torch.from_numpy(bits)
    es = NMSDecoder(code, DecoderConfig(decoding_type=1, early_stop=True), spec,
                    graph=graph, device="cpu")
    labelled = es.decode(p, x, labels=lab)
    folded = es.decode(p, x * (1.0 - 2.0 * lab))
    assert torch.equal(labelled.err_flags, folded.err_flags)
    assert torch.equal(labelled.bit_errors, folded.bit_errors)
    fixed = NMSDecoder(code, DecoderConfig(decoding_type=1), spec, graph=graph,
                       device="cpu").decode(p, x, labels=lab)
    assert torch.equal(labelled.uncor_mask, fixed.uncor_mask)
    # some words fail at every iteration, and some group of G words has
    # none, so its stop is taken
    per_group = labelled.uncor_mask.view(-1, es.kernel.group).any(dim=1)
    assert bool(per_group.any()) and not bool(per_group.all())


@pytest.mark.parametrize("collect", ["stats", "deploy"])
def test_labels_of_the_wrong_shape_raise(collect):
    """Labels are [target*z, B]: the full word under a systematic target,
    a batch of another size and the transposed labels all raise."""
    code = get_code(MACKAY)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=2)
    dec = NMSDecoder(code, DecoderConfig(decoding_type=1, target_node=48), spec,
                     device="cpu")
    p = init_weights(spec, dec.graph, device="cpu")
    llr = torch.full((code.n_full, 8), -2.0)
    for shape in ((code.n_full, 8), (48, 7), (8, 48)):
        with pytest.raises(ValueError, match="labels of shape"):
            dec.decode(p, llr, labels=torch.zeros(shape), collect=collect)
    ok = dec.decode(p, llr, labels=torch.zeros((48, 8), dtype=torch.bool), collect=collect)
    ref = dec.decode(p, llr, collect=collect)
    assert all(torch.equal(a, b) for a, b in zip(ok, ref) if a is not None)


def test_track_syndrome_config_and_card_raise():
    """`track_syndrome` with the early stop raises (JAX cannot produce the
    pair either); other collects leave `syndrome_ok` None.  (A decoder for
    the card takes `track_syndrome`: the fixed-T kernel writes the flags,
    `tests/test_torch_kernel_cuda.py`.)"""
    with pytest.raises(ValueError, match="early_stop"):
        DecoderConfig(track_syndrome=True, early_stop=True)
    code = get_code(MACKAY)
    spec = WeightSpec(sharing=(0, 0, 0), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(track_syndrome=True), spec, device="cpu")
    p = init_weights(spec, dec.graph, device="cpu")
    llr = torch.full((code.n_full, 4), -3.0)
    assert bool(dec.decode(p, llr).syndrome_ok.all())
    for collect in ("app_last", "apps"):
        assert dec.decode(p, llr, collect=collect).syndrome_ok is None


def test_apply_defaults_to_apps_as_jax():
    """`apply(params, llr)` returns the APP stack in both packages (JAX's
    default collect='apps'); `decode(params, llr)` returns stats."""
    jcode, jgraph, code, graph, params, _, llr = _inputs(MACKAY, (3, 3, 3), 2, 2.5, 4, 32,
                                                         seed=4)
    jdec = JaxDecoder(jcode, JaxConfig(), JaxSpec(sharing=(3, 3, 3), n_iters=4),
                      graph=jgraph)
    ref = jdec.apply(_jax(params), jnp.asarray(llr))
    dec = NMSDecoder(code, DecoderConfig(), WeightSpec(sharing=(3, 3, 3), n_iters=4),
                     graph=graph, device="cpu")
    p = params_from_numpy(params, device="cpu")
    res = dec.apply(p, torch.from_numpy(llr))
    assert ref.err_flags is None and res.err_flags is None and res.syndrome_ok is None
    assert res.apps.shape == (4, code.n_full, 32)
    np.testing.assert_allclose(res.apps.detach().numpy(), np.asarray(ref.apps), **APP_TOL)
    stats = dec.decode(p, torch.from_numpy(llr))
    assert stats.apps is None and stats.err_flags.shape == (4, 32)
    assert torch.equal(stats.app_last, res.apps[-1].detach())


# (id, code, sharing, decoding type, SNR dB, T, target_node); B = 32.  SP on
# wman, whose checks are sparse (SP's APPs drift from XLA's on dense checks,
# ROADMAP.md section 3), at 2 dB where few words converge (see LABEL_CASES)
APP_LAST_CASES = [
    ("mackay_ms", MACKAY, (3, 0, 3), 1, 2.5, 4, 48),
    ("mackay_qms_ucn", MACKAY, (3, 3, 3), 2, 2.5, 4, 48),
    ("wman_sp", WMAN, (3, 0, 3), 0, 2.0, 3, 18),
]


@pytest.mark.parametrize("case", APP_LAST_CASES, ids=[c[0] for c in APP_LAST_CASES])
def test_apply_app_last_under_a_systematic_target_matches_jax(case):
    """`apply(params, llr)` under ``target_node > 0``: `app_last` is the
    scan's carry, the last iteration's clipped APP over all N*z bits (not
    only the target rows of `apps`), equal to JAX's; the gradient of a loss
    on it, ``sum(app_last * r)``, equal to `jax.grad` of the same loss."""
    _, name, sharing, dec, snr, T, target = case
    jcode, jgraph, code, graph, params, _, llr = _inputs(name, sharing, dec, snr, T, 32,
                                                         seed=8)
    r = np.random.default_rng(9).standard_normal(llr.shape).astype(np.float32)
    jdec = JaxDecoder(jcode, JaxConfig(decoding_type=dec, q_bit=5, target_node=target),
                      JaxSpec(sharing=sharing, n_iters=T), graph=jgraph)

    def jloss(p):
        return jnp.sum(jdec.apply(p, jnp.asarray(llr)).app_last * jnp.asarray(r))

    ref = jdec.apply(_jax(params), jnp.asarray(llr))
    g_ref = jax.grad(jloss)(_jax(params))
    tdec = NMSDecoder(code, DecoderConfig(decoding_type=dec, q_bit=5, target_node=target),
                      WeightSpec(sharing=sharing, n_iters=T), graph=graph, device="cpu")
    tp = params_from_numpy(params, device="cpu")
    for v in tp.values():
        if v is not None:
            v.requires_grad_(True)
    res = tdec.apply(tp, torch.from_numpy(llr))
    nz, tz = code.n_full, target * code.z
    assert res.app_last.shape == (nz, 32) == ref.app_last.shape
    assert res.apps.shape == (T, tz, 32) == ref.apps.shape
    np.testing.assert_allclose(res.app_last.detach().numpy(), np.asarray(ref.app_last),
                               **APP_TOL)
    np.testing.assert_allclose(res.apps.detach().numpy(), np.asarray(ref.apps), **APP_TOL)
    assert torch.equal(res.app_last[:tz], res.apps[-1])
    (res.app_last * torch.from_numpy(r)).sum().backward()
    for kind in ("cn", "ucn", "vn"):
        if tp[kind] is None:
            assert g_ref[kind] is None
            continue
        g = np.asarray(g_ref[kind])
        scale = max(float(np.abs(g).max()), 1e-8)
        np.testing.assert_allclose(tp[kind].grad.numpy(), g, rtol=5e-5, atol=5e-6 * scale,
                                   err_msg=f"{kind} gradient (scale {scale:.3e})")
        assert float(tp[kind].grad.abs().max()) > 0.0


def test_boosted_decode_with_labels_matches_jax():
    """`BoostedDecoder.decode(llr, labels=...)` passes the labels through:
    per-iteration counters and the base stage's failure mask equal JAX's."""
    jcode, jgraph, code, graph, params, bits, llr = _inputs(WMAN, (3, 3, 3), 2, 3.0, 6, 32,
                                                            seed=5)
    jspec, spec = JaxSpec(sharing=(3, 3, 3), n_iters=6), WeightSpec(sharing=(3, 3, 3),
                                                                      n_iters=6)
    jb = JaxBoosted(jcode, JaxConfig(), jspec, _jax(params), boundary=4, graph=jgraph)
    ref = jb.decode(jnp.asarray(llr), labels=jnp.asarray(bits))
    tb = BoostedDecoder(code, DecoderConfig(), spec, params_from_numpy(params, device="cpu"),
                        boundary=4, graph=graph, device="cpu")
    res = tb.decode(torch.from_numpy(llr), labels=torch.from_numpy(bits))
    np.testing.assert_array_equal(res.err_flags.numpy(), np.asarray(ref.err_flags))
    np.testing.assert_array_equal(res.bit_errors.numpy(), np.asarray(ref.bit_errors))
    np.testing.assert_array_equal(tb.base_failure_mask(res).numpy(),
                                  np.asarray(jb.base_failure_mask(ref)))
    assert int(res.err_flags[-1].sum()) > 0


@pytest.mark.parametrize("meta", [None, {"source": "IEEE 802.16e", "z": 24}])
def test_save_proto_json_byte_equal_to_jax(tmp_path, meta):
    proto = load_proto_matrix(WMAN)
    np.testing.assert_array_equal(proto, jax_load_proto(WMAN))
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    save_proto_json(proto, str(ours), meta=meta)
    jax_save_proto_json(proto, str(theirs), meta=meta)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(load_proto_matrix(str(ours)), proto)


@pytest.mark.parametrize("early_stop", [False, True])
def test_counts_are_the_stats_without_the_app(early_stop):
    """collect='counts' (the simulator's and the harvester's) gives the
    flags and counts of collect='stats' with no final APP."""
    _, _, code, graph, params, bits, llr = _inputs(MACKAY, (3, 0, 3), 2, 4.0, 6, 64, seed=2)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=6)
    dec = NMSDecoder(code, DecoderConfig(early_stop=early_stop), spec, graph=graph,
                     device="cpu")
    p, x = params_from_numpy(params, device="cpu"), torch.from_numpy(llr)
    stats, counts = dec.decode(p, x), dec.decode(p, x, collect="counts")
    assert stats.app_last is not None and counts.app_last is None
    assert torch.equal(stats.err_flags, counts.err_flags)
    assert torch.equal(stats.bit_errors, counts.bit_errors)
    assert torch.equal(stats.uncor_mask, counts.uncor_mask)

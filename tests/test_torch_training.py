"""The port's training pieces against the JAX package on identical numpy
inputs: losses (both eta paths) and their gradients, the straight-through
functions, the weight-row helpers, the block schedule, two Adam steps of
`make_train_step`, the perf log, and the evaluator in data mode.

Tolerances: STE values and gradients, row helpers, schedule, perf-log bytes
and evaluator counters exact; losses within rtol 1e-6 and their gradients
within rtol 1e-6 / atol 1e-9; Adam-stepped weights within rtol 1e-5 and atol
1e-7 (as the JAX package holds its fused step to its scan step).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.io.perflog import PerfLog as JaxPerfLog
from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.models import weights as jw
from ldpc_error_floor_tpu.ops import ste as jste
from ldpc_error_floor_tpu.pipelines.config import \
    ExperimentConfig as JaxExperimentConfig
from ldpc_error_floor_tpu.pipelines.evaluate import Evaluator as JaxEvaluator
from ldpc_error_floor_tpu.training import losses as jlosses
from ldpc_error_floor_tpu.training import schedule as jschedule
from ldpc_error_floor_tpu.training.train import make_optimizer as jax_optimizer
from ldpc_error_floor_tpu.training.train import \
    make_train_step as jax_train_step
from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io.perflog import PerfLog
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, clip_weights,
                                               params_from_numpy,
                                               params_to_blocks, params_to_numpy,
                                               partial_update_from_blocks,
                                               trainable_mask)
from ldpc_error_floor_tpu_torch.ops import ste
from ldpc_error_floor_tpu_torch.pipelines import ExperimentConfig, Evaluator
from ldpc_error_floor_tpu_torch.training import (make_optimizer,
                                                 make_train_step,
                                                 multi_iteration_loss,
                                                 n_blocks, training_blocks)

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
MACKAY = "MACKAY_N96_K48"


def _grad_torch(fn, x):
    t = torch.from_numpy(x).requires_grad_(True)
    y = fn(t)
    y.backward(torch.ones_like(y))
    return y.detach().numpy(), t.grad.numpy()


def _grad_jax(fn, x):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.ones_like(y))[0])


# ----- losses ------------------------------------------------------------------

@pytest.mark.parametrize("loss_type", [0, 1, 2])
@pytest.mark.parametrize("etha,t_start", [(0.0, 0), (0.5, 0), (0.8, 2), (1.0, 1)])
def test_losses_match_jax(loss_type, etha, t_start):
    rng = np.random.default_rng(loss_type)
    apps = (0.5 * rng.integers(-10, 30, (4, 48, 16))).astype(np.float32)
    apps[:, :, 0] = 7.5                       # ties in the soft-FER min
    apps[1, :, 3] = 0.0                       # APP exactly 0
    labels = (rng.random((48, 16)) < 0.3).astype(np.float32) if loss_type == 0 \
        else np.zeros((48, 16), np.float32)
    lj, gj = _grad_jax(lambda a: jlosses.multi_iteration_loss(
        a, jnp.asarray(labels), loss_type, etha, t_start=t_start), apps)
    lt, gt = _grad_torch(lambda a: multi_iteration_loss(
        a, torch.from_numpy(labels), loss_type, etha, t_start=t_start), apps)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-9)
    # a tensor eta takes the general path, to the same value
    lg = multi_iteration_loss(torch.from_numpy(apps), torch.from_numpy(labels),
                              loss_type, torch.tensor(etha), t_start=t_start)
    np.testing.assert_allclose(float(lg), lj, rtol=1e-6)


def test_empty_loss_window_raises():
    """The JAX loss divides 0 by 0 when t_start > T-1; the port refuses."""
    apps = torch.zeros((3, 8, 4))
    labels = torch.zeros((8, 4))
    jl = jlosses.multi_iteration_loss(jnp.zeros((3, 8, 4)), jnp.zeros((8, 4)),
                                      2, 0.5, t_start=3)
    assert np.isnan(float(jl))
    for etha in (0.0, 0.5):
        with pytest.raises(ValueError, match="t_start"):
            multi_iteration_loss(apps, labels, 2, etha, t_start=3)
    with pytest.raises(ValueError, match="loss_type"):
        multi_iteration_loss(apps, labels, 5, 0.0)


# ----- straight-through functions -------------------------------------------------

def test_ste_functions_match_jax():
    # the QMS grid, its clip bounds, points just outside them, and halves
    x = np.concatenate([np.arange(-9.0, 9.01, 0.25), [-7.5, 7.5, 7.5001, -7.5001,
                                                      20.0, -20.0, 20.5, 0.0]])
    x = x.astype(np.float32)
    pairs = [(lambda a: ste.quantize_ste(a, 5), lambda a: jste.quantize_ste(a, 5)),
             (lambda a: ste.quantize_ste(a, 3), lambda a: jste.quantize_ste(a, 3)),
             (lambda a: ste.clip_tf_grad(a, -7.5, 7.5),
              lambda a: jste.clip_tf_grad(a, -7.5, 7.5)),
             (ste.inv_exp, jste.inv_exp), (ste.sign_ste, jste.sign_ste)]
    for i, (ft, fj) in enumerate(pairs):
        yt, gt = _grad_torch(ft, x)
        yj, gj = _grad_jax(fj, x)
        if i < 3:  # exact: grid values and 0/1 masks
            np.testing.assert_array_equal(yt, yj)
            np.testing.assert_array_equal(gt, gj)
        else:      # sigmoid in both, to an ulp
            np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-7)
    # the gradient is 1 inside the clip inclusive, 0 outside
    _, g = _grad_torch(lambda a: ste.quantize_ste(a, 5), x)
    np.testing.assert_array_equal(g, (np.abs(x) <= 7.5).astype(np.float32))
    # a tensor that needs no gradient takes the plain formula, same values
    np.testing.assert_array_equal(ste.quantize_ste(torch.from_numpy(x), 5).numpy(),
                                  np.asarray(jste.quantize_ste(jnp.asarray(x), 5)))


# ----- weight rows and schedule ----------------------------------------------------

@pytest.mark.parametrize("sharing,fixed_iter", [((3, 3, 3), 0), ((1, 1, 2), 2),
                                                ((4, 4, 5), 3), ((2, 0, 0), 1)])
def test_row_helpers_match_jax(sharing, fixed_iter):
    T, start, end, fixed_init = 6, 4, 6, 1
    jg = JaxGraph(jax_get_code(WMAN))
    graph = TannerGraph(get_code(WMAN))
    jspec = JaxSpec(sharing=sharing, n_iters=T, fixed_iter=fixed_iter,
                    min_w=0.2, max_w=1.5)
    spec = WeightSpec(sharing=sharing, n_iters=T, fixed_iter=fixed_iter,
                      min_w=0.2, max_w=1.5)
    rng = np.random.default_rng(1)
    params = {k: None if jspec.dim(k, jg) == 0 else rng.uniform(
        -0.5, 2.5, (jspec.n_rows(k), jspec.dim(k, jg))).astype(np.float32)
        for k in ("cn", "ucn", "vn")}
    jmask = jw.trainable_mask(jspec, start, end, fixed_init)
    tmask = trainable_mask(spec, start, end, fixed_init)
    for k in jmask:
        assert (jmask[k] is None) == (tmask[k] is None)
        if jmask[k] is not None:
            np.testing.assert_array_equal(tmask[k], jmask[k])
    jm = {k: None if v is None else jnp.asarray(v[:, None], jnp.float32)
          for k, v in jmask.items()}
    jc = jw.clip_weights(jspec, {k: None if v is None else jnp.asarray(v)
                                 for k, v in params.items()}, masks=jm)
    tc = clip_weights(spec, params_from_numpy(params, "cpu"), masks=tmask)
    for k, v in params_to_numpy(tc).items():
        if v is None:
            assert jc[k] is None
        else:
            np.testing.assert_array_equal(v, np.asarray(jc[k]))
    jb = jw.params_to_blocks(jspec, jc)
    tb = params_to_blocks(spec, tc)
    for k in jb:
        if jb[k] is None:
            assert tb[k] is None
        else:
            np.testing.assert_array_equal(np.stack(tb[k]), np.stack(jb[k]))
    # frozen-prefix load of the first `start` iterations from other rows
    blocks = {k: None if v is None else [r + 10.0 for r in v] for k, v in jb.items()}
    jp = jw.partial_update_from_blocks(jspec, jc, blocks, start, jg)
    tp = partial_update_from_blocks(spec, tc, blocks, start, graph)
    for k, v in params_to_numpy(tp).items():
        if v is not None:
            np.testing.assert_array_equal(v, np.asarray(jp[k]))


def test_training_blocks_match_jax():
    for args in [(20, 0, 20), (30, 20, 10), (30, 0, 10), (25, 5, 7), (3, 4, 1)]:
        assert list(training_blocks(*args)) == list(jschedule.training_blocks(*args))
        assert n_blocks(*args) == jschedule.n_blocks(*args)


# ----- Adam steps ------------------------------------------------------------------------

@pytest.mark.parametrize("sharing,T,block,fixed_init,etha", [
    ((3, 0, 3), 3, (0, 3), 0, 0.5),
    ((3, 3, 3), 4, (2, 4), 1, 0.0),  # static eta = 0: the port windows its APPs
])
def test_two_adam_steps_match_jax(sharing, T, block, fixed_init, etha):
    jcode = jax_get_code(WMAN)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=sharing, n_iters=T)
    rng = np.random.default_rng(7)
    params = {k: None if jspec.dim(k, jgraph) == 0 else rng.uniform(
        0.7, 1.3, (jspec.n_rows(k), jspec.dim(k, jgraph))).astype(np.float32)
        for k in ("cn", "ucn", "vn")}
    B = 16
    sigma = np.full((B,), np.float32(jcode.snr_sigmas([2.5])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((jcode.n_full, B)) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode)._llr(jnp.asarray(y), jnp.asarray(sigma)))
    labels = np.zeros((jcode.n_full, B), np.float32)
    static = 0.0 if etha == 0.0 else None

    jdec = JaxDecoder(jcode, JaxConfig(), jspec, graph=jgraph)
    opt = jax_optimizer(1e-2)
    jp = {k: None if v is None else jnp.asarray(v) for k, v in params.items()}
    st = opt.init(jp)
    jstep = jax_train_step(jdec, jspec, loss_type=2, train_start=block[0],
                           train_end=block[1], fixed_init=fixed_init,
                           optimizer=opt, donate=False, static_etha=static)
    jlosses_ = []
    for _ in range(2):
        (jp, st), loss = jstep(jp, st, jnp.asarray(llr), jnp.asarray(labels),
                               jnp.float32(etha))
        jlosses_.append(float(loss))

    code = get_code(WMAN)
    spec = WeightSpec(sharing=sharing, n_iters=T)
    cfg = DecoderConfig(app_t0=T - 1 if static == 0.0 else 0)
    tdec = NMSDecoder(code, cfg, spec, graph=TannerGraph(code), device="cpu")
    tp = params_from_numpy(params, "cpu")
    optimizer = make_optimizer(tp, 1e-2)
    step = make_train_step(tdec, spec, loss_type=2, train_start=block[0],
                           train_end=block[1], fixed_init=fixed_init,
                           static_etha=static)
    tlosses = [float(step(tp, optimizer, torch.from_numpy(llr),
                          torch.from_numpy(labels), etha)) for _ in range(2)]
    np.testing.assert_allclose(tlosses, jlosses_, rtol=1e-6)
    lo = max(block[0] - fixed_init, 0)
    for k, v in params_to_numpy(tp).items():
        if v is None:
            continue
        np.testing.assert_allclose(v, np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(v[:lo], params[k][:lo])  # frozen rows
        assert not np.array_equal(v[lo:block[1]], params[k][lo:block[1]])


def test_window_without_static_eta_raises():
    code = get_code(WMAN)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=3)
    dec = NMSDecoder(code, DecoderConfig(app_t0=2), spec, device="cpu")
    with pytest.raises(ValueError, match="app_t0"):
        make_train_step(dec, spec, 2, 0, 3, static_etha=None)


# ----- perf log and evaluator ---------------------------------------------------------------

def test_perflog_bytes_match_jax(tmp_path):
    kw = dict(code=MACKAY, sharing=(3, 3, 3), snrs=[2.0, 2.5], batch_size=64,
              learn_rate_start=1e-2, epochs=3)
    logs = []
    for name, Log, Cfg in (("jax", JaxPerfLog, JaxExperimentConfig),
                           ("torch", PerfLog, ExperimentConfig)):
        path = str(tmp_path / f"{name}.txt")
        log = Log(path, echo=False)
        log.header(Cfg(**kw).validate())
        log.train_result(1, 3, 0, 20, 0.0123456)
        log.eval_result("Valid", np.array([[1e-3, 2e-4], [0.5, 0.25], [0.1, 0.0],
                                           [0.333, 1.0]]), 0.75)
        log.timing(1.234, 0.5, 0.0)
        logs.append(open(path, "rb").read())
    assert logs[0] == logs[1] and len(logs[0]) > 400


@pytest.mark.parametrize("compute_loss", [True, False])
def test_evaluator_data_mode_matches_jax(compute_loss):
    T, B, nb = 4, 16, 3
    jcode = jax_get_code(MACKAY)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=(3, 0, 3), n_iters=T)
    rng = np.random.default_rng(3)
    params = {"cn": rng.uniform(0.7, 1.3, (T, 1)).astype(np.float32), "ucn": None,
              "vn": rng.uniform(0.7, 1.3, (T, 1)).astype(np.float32)}
    sigma = np.float32(jcode.snr_sigmas([1.5])[0])
    y = (-1.0 + rng.standard_normal((jcode.n_full, nb * B)) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode)._llr(jnp.asarray(y),
                                          jnp.full((nb * B,), sigma)))
    rows = llr.T.copy()
    jdec = JaxDecoder(jcode, JaxConfig(), jspec, graph=jgraph)
    jev = JaxEvaluator(jdec, JaxChannel(jcode), 2, t_lo=1, batch=B,
                       compute_loss=compute_loss)
    ref, _ = jev.run({k: None if v is None else jnp.asarray(v)
                      for k, v in params.items()}, [0.0], nb * B, 0.5, data=rows)
    code = get_code(MACKAY)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=T)
    tdec = NMSDecoder(code, DecoderConfig(), spec, device="cpu")
    tev = Evaluator(tdec, AWGNChannel(code, device="cpu"), 2, t_lo=1, batch=B,
                    compute_loss=compute_loss)
    res, _ = tev.run(params_from_numpy(params, "cpu"), [0.0], nb * B, 0.5, data=rows)
    counts = np.array([B * code.n_full * nb, B * nb, B * nb])[:, None]
    np.testing.assert_array_equal(np.rint(res[:3] * counts), np.rint(ref[:3] * counts))
    assert 0 < ref[1, 0] < 1  # some words decode, some fail
    np.testing.assert_allclose(res[3], ref[3], rtol=1e-6)
    # with compute_loss the stack comes from B4's plain version, unwindowed
    if compute_loss:
        windowed = NMSDecoder(code, DecoderConfig(app_t0=T - 1), spec, device="cpu")
        with pytest.raises(ValueError, match="app_t0"):
            Evaluator(windowed, tev.channel, 2, batch=B)


def test_cli_evaluate_decodes_under_the_configs_neural_mode(tmp_path, capsys):
    """The port's `evaluate` passes the config's `neural_mode` to the
    decoder (the JAX CLI's `evaluate` drops it and decodes under 'scale'):
    on a MacKay offset config in data mode its counters equal the JAX
    `Evaluator` built with neural_mode='offset', and its loss within rtol
    1e-6, on the same numpy-made words and weight file."""
    import json

    from ldpc_error_floor_tpu.models import load_params as jax_load_params
    from ldpc_error_floor_tpu_torch.cli import main
    from ldpc_error_floor_tpu_torch.io import (append_uncor_file, read_uncor_file,
                                             write_weight_file)

    T, B, sharing = 4, 16, (3, 0, 3)
    jcode = jax_get_code(MACKAY)
    rng = np.random.default_rng(11)
    blocks = {"cn": rng.uniform(0.0, 0.6, (T, 1)).astype(np.float32), "ucn": None,
              "vn": rng.uniform(0.7, 1.3, (T, 1)).astype(np.float32)}
    wfile = str(tmp_path / "offset_weights.txt")
    write_weight_file(wfile, sharing, params_to_blocks(
        WeightSpec(sharing=sharing, n_iters=T), params_from_numpy(blocks, "cpu")))
    sigma = np.float32(jcode.snr_sigmas([1.5])[0])
    in_dir = tmp_path / "Inputs"
    in_dir.mkdir()
    for split in ("Valid", "Test"):
        y = (-1.0 + rng.standard_normal((2 * B, jcode.n_full)) * sigma).astype(np.float32)
        append_uncor_file(str(in_dir / f"[Uncor]_{MACKAY}_{split}.txt"),
                          (2.0 * y / sigma ** 2).astype(np.float32))
    cfg = ExperimentConfig(code=MACKAY, sharing=sharing, decoding_type=2, iters_max=T,
                           neural_mode="offset", loss_type=2, etha_start=0.5,
                           sampling_type=1, snrs=[1.5], valid_num=2 * B, test_num=2 * B,
                           input_dir=str(in_dir), out_dir=str(tmp_path))
    cfg_path = str(tmp_path / "offset.json")
    cfg.to_json(cfg_path)
    assert main(["evaluate", "--config", cfg_path, "--weights", wfile, "--batch", str(B),
                 "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["split"] for r in rows] == ["valid", "test"]
    jspec = JaxSpec(sharing=sharing, n_iters=T)
    jgraph = JaxGraph(jcode)
    jdec = JaxDecoder(jcode, JaxConfig(neural_mode="offset"), jspec, graph=jgraph)
    jparams = jax_load_params(jspec, jgraph, wfile)
    counts = np.array([2 * B * jcode.n_full, 2 * B, 2 * B], np.float64)
    for row, split in zip(rows, ("Valid", "Test")):
        data = read_uncor_file(str(in_dir / f"[Uncor]_{MACKAY}_{split}.txt"))
        ref, _ = JaxEvaluator(jdec, JaxChannel(jcode), 2, batch=B).run(
            jparams, [0.0], 2 * B, 0.5, data=data)
        got = np.array([row["ber_last"], row["fer_last"], row["fer"]])
        np.testing.assert_array_equal(np.rint(got * counts), np.rint(ref[:3, 0] * counts))
        np.testing.assert_allclose(row["loss"], ref[3, 0], rtol=1e-6)
        assert 0.0 < ref[1, 0] < 1.0  # some words decode, some fail

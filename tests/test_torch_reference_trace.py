"""The port against golden traces of the executed reference TF graph.

`tests/data/ref_traces/*.npz` hold, for six pinned configurations, the
reference graph's per-iteration APPs, its loss and its gradients with
respect to its weight variables (`tests/test_reference_trace.py` holds the
JAX package to them).  These tests hold the port to the same numbers, with
nothing of JAX: the plain PyTorch path (`NMSDecoder.apply(collect='apps')`
on CPU tensors: autograd through `ops/fused_decoder.py::plain_iterations`)
here, and on the card (marker `cuda`; `python -m pytest --noconftest -m cuda
tests/test_torch_reference_trace.py`) the CUDA training pair (B4/B5, for SP
B4-SP/B5-SP) and the decode kernel's final APP (B1, for SP B1-SP).

Tolerances as `tests/test_reference_trace.py`: APPs rtol 1e-5 and atol 2e-4
(2e-3 for SP: float32 tanh/atanh differ in the last ulps between TF and
PyTorch and the error compounds over iterations), the loss rtol 1e-4 and
atol 1e-6, each gradient row rtol 2e-3 and atol 1e-6.
"""

import glob
import os

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import DecoderConfig, NMSDecoder, WeightSpec
from ldpc_error_floor_tpu_torch.training.losses import multi_iteration_loss

TRACE_DIR = os.path.join(os.path.dirname(__file__), "data", "ref_traces")
TRACES = sorted(glob.glob(os.path.join(TRACE_DIR, "*.npz")))
IDS = [os.path.basename(p)[:-4] for p in TRACES]
KIND_IDX = {"cn": 0, "ucn": 1, "vn": 2}


def _load(path):
    d = dict(np.load(path))
    meta = {k: int(d[k]) for k in ("decoding_type", "q_bit", "T", "loss_type",
                                   "fixed_iter", "fixed_init", "target_node")}
    meta["code"] = d["code"].tobytes().decode()
    meta["sharing"] = tuple(int(v) for v in d["sharing"])
    meta["etha"] = float(d["etha"])
    return d, meta


def _setup(path, device):
    """A trace's data and metadata, the port's decoder for its
    configuration, its weight rows (requiring gradients) and its LLRs
    [N*z, B]."""
    d, meta = _load(path)
    code = get_code(meta["code"])
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=meta["sharing"], n_iters=meta["T"],
                      fixed_iter=meta["fixed_iter"])
    target = meta["target_node"] if meta["target_node"] != code.N else 0
    cfg = DecoderConfig(decoding_type=meta["decoding_type"], q_bit=meta["q_bit"],
                        target_node=target)
    dec = NMSDecoder(code, cfg, spec, graph=graph, device=device)
    params = {}
    for kind, i in KIND_IDX.items():
        if meta["sharing"][i] == 0:
            params[kind] = None
            continue
        rows = np.stack([d[f"w_var_{i}_{t}"] for t in range(spec.n_rows(kind))])
        params[kind] = torch.tensor(rows, dtype=torch.float32, device=device,
                                    requires_grad=True)
    xa = d["xa"]  # [B, N, z]
    llr = torch.tensor(xa.transpose(1, 2, 0).reshape(-1, xa.shape[0]),
                       dtype=torch.float32, device=device).contiguous()
    return d, meta, dec, params, llr


def _run(path, device):
    """The port on a trace's inputs and weights: (APPs [T, B, target*z],
    loss, gradients of the stored weight rows)."""
    d, meta, dec, params, llr = _setup(path, device)
    code = dec.code
    t_lo = max(meta["fixed_iter"] - meta["fixed_init"], meta["fixed_iter"])
    apps = dec.apply(params, llr, collect="apps").apps
    labels = torch.zeros((dec.target * code.z, llr.shape[1]), device=device)
    loss = multi_iteration_loss(apps, labels, meta["loss_type"], meta["etha"],
                                t_start=t_lo)
    loss.backward()
    grads = {k: p.grad.cpu().numpy() for k, p in params.items() if p is not None}
    return (d, meta, t_lo, apps.detach().cpu().numpy().transpose(0, 2, 1),
            float(loss.detach()), grads, dec)


def _assert_trace(path, device):
    d, meta, t_lo, apps, loss, grads, _ = _run(path, device)
    atol = 2e-3 if meta["decoding_type"] == 0 else 2e-4
    np.testing.assert_allclose(apps, d["apps"], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(loss, float(d["loss"]), rtol=1e-4, atol=1e-6)
    checked = 0
    for kind, i in KIND_IDX.items():
        share = meta["sharing"][i]
        if share == 0:
            continue
        # temporal sharing: the pivot row; else every row of the loss window
        rows = [meta["fixed_iter"]] if share in (4, 5) else range(t_lo, meta["T"])
        for t in rows:
            np.testing.assert_allclose(grads[kind][t], d[f"g_var_{i}_{t}"], rtol=2e-3,
                                       atol=1e-6, err_msg=f"{kind} row {t}")
            checked += 1
    assert checked > 0


def test_traces_exist():
    assert len(TRACES) >= 6 and "mackay_sp" in IDS, TRACES


@pytest.mark.parametrize("path", TRACES, ids=IDS)
def test_plain_path_matches_reference(path):
    """APPs, loss and gradients of the port's plain path on the CPU."""
    _assert_trace(path, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("path", TRACES, ids=IDS)
def test_training_pair_matches_reference_on_card(path):
    """The same through the CUDA training pair (B4/B5; mackay_sp through
    B4-SP/B5-SP)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _assert_trace(path, torch.device("cuda"))
    dec = _run(path, torch.device("cuda"))[-1]
    torch.cuda.synchronize()
    assert dec.train_kernel.launches == {dec.train_kernel.fwd_name: 1,
                                         dec.train_kernel.bwd_name: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("path", TRACES, ids=IDS)
def test_decode_kernel_matches_reference_on_card(path):
    """The decode kernel B1 (mackay_sp: B1-SP), collect='app_last': the
    final APP on the target columns against the trace's last iteration,
    in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    d, meta, dec, params, llr = _setup(path, torch.device("cuda"))
    with torch.no_grad():
        app = dec.decode(params, llr, collect="app_last").app_last
    torch.cuda.synchronize()
    atol = 2e-3 if meta["decoding_type"] == 0 else 2e-4
    got = app[: dec.target * dec.z].cpu().numpy().T
    np.testing.assert_allclose(got, d["apps"][-1], rtol=1e-5, atol=atol)
    want = "fused_nms_stats_sp" if meta["decoding_type"] == 0 else "fused_nms_stats"
    assert dec.kernel.launches == {want: 1}

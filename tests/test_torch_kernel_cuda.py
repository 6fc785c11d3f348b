"""The CUDA decode kernel against its plain PyTorch version on the card.

These tests need a CUDA card and skip without one.  They import nothing of
JAX, so they run on a machine without it; `tests/conftest.py` imports JAX,
so on the card run them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances: QMS counters integer-equal and APPs bit-equal (==); MS and
MS_RAW counters integer-equal and APPs within atol 1e-4 / rtol 1e-5.
"""

import pytest
import torch

from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import DecoderConfig, WeightSpec
from ldpc_error_floor_tpu_torch.ops.fused_decoder import FusedNMSKernel

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"

# (code, sharing, decoding_type, neural_mode, target_node)
CASES = [
    (WMAN, (3, 3, 3), 2, "scale", 0),
    (WMAN, (2, 2, 2), 1, "scale", 0),
    (WMAN, (1, 0, 0), 3, "scale", 0),
    (WMAN, (4, 4, 5), 2, "offset", 0),
    ("MACKAY_N96_K48", (3, 3, 3), 2, "scale", 0),
    (G5, (2, 2, 2), 2, "scale", 10),
    ("802_11n_N648_R56_z27", (3, 0, 3), 2, "scale", 0),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}_{c[3]}")
def test_kernel_matches_plain_on_card(case):
    dev = _cuda()
    code_name, sharing, dec, mode, target = case
    code = get_code(code_name)
    graph = TannerGraph(code)
    temporal = any(s in (4, 5) for s in sharing)
    spec = WeightSpec(sharing=sharing, n_iters=6, fixed_iter=2 if temporal else 0)
    cfg = DecoderConfig(decoding_type=dec, neural_mode=mode, target_node=target)
    kern = FusedNMSKernel(graph, cfg, spec)
    gen = torch.Generator(device=dev).manual_seed(3)
    lo = 0.0 if mode == "offset" else 0.7
    stacked = {k: None if spec.dim(k, graph) == 0 else
               (lo + 0.6 * torch.rand((6, spec.dim(k, graph)), generator=gen,
                                      device=dev)).contiguous()
               for k in ("cn", "ucn", "vn")}
    sig = torch.full((1000,), float(code.snr_sigmas([2.5])[0]), device=dev)
    llr = AWGNChannel(code, decoding_type=dec, device=dev).sample(gen, sig)
    app, err, nerr = kern.decode_stats(stacked, llr)
    app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert torch.equal(err, err_p) and torch.equal(nerr, nerr_p)
    if dec == 2:
        assert bool((app == app_p).all())
    else:
        torch.testing.assert_close(app, app_p, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_sp_and_bad_inputs_on_card():
    dev = _cuda()
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=2)
    llr = torch.zeros((code.n_full, 8), device=dev)
    sp = FusedNMSKernel(graph, DecoderConfig(decoding_type=0), spec)
    w = {"cn": torch.ones((2, 1), device=dev), "ucn": None,
         "vn": torch.ones((2, 1), device=dev)}
    with pytest.raises(NotImplementedError, match="B1-SP"):
        sp.decode_stats(w, llr)
    kern = FusedNMSKernel(graph, DecoderConfig(), spec)
    with pytest.raises(ValueError, match="llr"):
        kern.decode_stats(w, llr[:, ::2])
    with pytest.raises(ValueError, match="cn weights"):
        kern.decode_stats({**w, "cn": torch.ones((3, 1), device=dev)}, llr)
    assert kern.launches == 0

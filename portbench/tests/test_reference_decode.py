"""The plain reference decoder against the port's plain path on the CPU,
and its joined and pooled schedule against one batch at a time."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drive import points


def _ref(cfg_name):
    cfg = harness.config(harness.load_bench(), cfg_name)
    return cfg, points.reference_decoder(cfg, "cpu")


def _llrs(ref, snr, seed, n, batch):
    gen = torch.Generator().manual_seed(seed)
    sigma = ref.code.sigma(snr)
    return [ref.llr(torch.randn((ref.code.n_full, batch), generator=gen), sigma)
            for _ in range(n)]


@pytest.mark.parametrize("cfg_name,snr", [("wman576-base20", 3.0),
                                          ("nr5g-r050-z64-iter50", 1.5)])
def test_genie_matches_the_port_plain_path(cfg_name, snr):
    from ldpc_error_floor_tpu_torch.codes import Code, TannerGraph
    from ldpc_error_floor_tpu_torch.io import read_weight_json
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder, WeightSpec,
                                                   params_from_blocks, stack_weights)
    cfg, ref = _ref(cfg_name)
    c, d = cfg["code"], cfg["decoder"]
    code = Code.load(str(harness.path(c["file"])), z=c["z"], punct=tuple(c["punct"]),
                     short=tuple(c["short"]))
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=tuple(d["sharing"]), n_iters=d["n_iters"])
    dec = NMSDecoder(code, DecoderConfig(q_bit=d["q_bit"], target_node=d["target_node"]),
                     spec, graph=graph, device="cpu")
    params = params_from_blocks(spec, read_weight_json(str(harness.path(cfg["weights"])))[1],
                                graph, device="cpu")
    llr = _llrs(ref, snr, 7, 1, 256)[0]
    err = dec.kernel.decode_stats_plain(stack_weights(spec, params), llr)[1]
    fails, iters = ref.genie([llr])
    assert 0 < fails < 256
    assert fails == int(err.all(dim=0).sum())
    first_right = torch.where(err.all(dim=0), d["n_iters"] - 1,
                              (~err).int().argmax(dim=0))
    assert iters == int((first_right + 1).sum())


def test_joined_and_pooled_schedule_matches_batch_by_batch(monkeypatch):
    _, ref = _ref("wman576-base20")
    llrs = _llrs(ref, 3.5, 11, 6, 512)
    alone = [ref.genie([x]) for x in llrs]
    monkeypatch.setattr(ref, "WIDE", 1024)
    monkeypatch.setattr(ref, "POOL", 64)
    joined = ref.genie(llrs)
    assert joined == tuple(np.sum(alone, axis=0))

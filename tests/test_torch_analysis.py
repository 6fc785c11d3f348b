"""The port's failure analysis and weight conversion against the JAX
package's.

`classify_failures` on LLR rows made with numpy (MacKay, QMS, so both
decodes are bit-equal) gives JAX's report exactly: words, failures, rescues,
the (a, b) classes and the variable-node hits, and the same summary text;
the batch remainder is dropped as JAX drops it.  `analyze-uncor --device
cpu` prints JAX's text, and `convert-weights` writes JAX's bytes.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu import cli as jax_cli
from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.sim import classify_failures as jax_classify
from ldpc_error_floor_tpu_torch import cli
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io import (append_uncor_file,
                                           bundled_weight_path,
                                           write_weight_file)
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, params_from_numpy,
                                               params_to_blocks)
from ldpc_error_floor_tpu_torch.sim import classify_failures

torch.set_num_threads(1)

MACKAY = "MACKAY_N96_K48"
SHARING, T = (3, 3, 3), 5


def _inputs(num, seed=21, snr=1.0):
    """Random weights and `num` LLR rows [num, N*z] at a low SNR (the JAX
    channel's LLRs from numpy noise), both in numpy."""
    rng = np.random.default_rng(seed)
    jcode = jax_get_code(MACKAY)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=SHARING, n_iters=T)
    params = {k: rng.uniform(0.7, 1.3, (jspec.n_rows(k), jspec.dim(k, jgraph)))
              .astype(np.float32) for k in ("cn", "ucn", "vn")}
    sigma = np.full((num,), np.float32(jcode.snr_sigmas([snr])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((jcode.n_full, num)) * sigma).astype(np.float32)
    llr = np.array(JaxChannel(jcode, decoding_type=2)._llr(jnp.asarray(y),
                                                           jnp.asarray(sigma)))
    return jcode, jgraph, jspec, params, np.ascontiguousarray(llr.T)


@pytest.mark.parametrize("num,batch", [(150, 64), (40, 64)])
def test_failure_report_equals_jax(num, batch):
    jcode, jgraph, jspec, params, rows = _inputs(num)
    jdec = JaxDecoder(jcode, JaxConfig(), jspec, graph=jgraph)
    ref = jax_classify(jdec, {k: jnp.asarray(v) for k, v in params.items()}, rows,
                       batch=batch)
    code = get_code(MACKAY)
    dec = NMSDecoder(code, DecoderConfig(), WeightSpec(sharing=SHARING, n_iters=T),
                     graph=TannerGraph(code), device="cpu")
    rep = classify_failures(dec, params_from_numpy(params, "cpu"), rows, batch=batch)
    # the remainder rule: whole batches only, or all rows below one batch
    assert rep.total_words == ref.total_words == (128 if num > batch else num)
    assert 0 < rep.still_failing < rep.total_words
    assert (rep.still_failing, rep.rescued) == (ref.still_failing, ref.rescued)
    assert rep.classes == ref.classes and len(rep.classes) > 1
    np.testing.assert_array_equal(rep.vn_hits, ref.vn_hits)
    assert rep.top_classes == ref.top_classes
    assert rep.summary() == ref.summary() and rep.summary(3) == ref.summary(3)
    assert not dec.kernel.launches  # CPU tensors take the plain version


def test_cli_analyze_uncor_prints_jax_text(tmp_path, capsys):
    jcode, jgraph, jspec, params, rows = _inputs(100, seed=5)
    uncor, wfile = str(tmp_path / "Uncor.txt"), str(tmp_path / "w.txt")
    append_uncor_file(uncor, rows)
    spec = WeightSpec(sharing=SHARING, n_iters=T)
    write_weight_file(wfile, SHARING, params_to_blocks(spec, params_from_numpy(params, "cpu")))
    args = ["--uncor", uncor, "--code", MACKAY, "--weights", wfile, "--iters", str(T),
            "--batch", "32", "--top", "4"]
    assert cli.main(["analyze-uncor", "--device", "cpu", *args]) == 0
    ours = capsys.readouterr().out
    jax_args = argparse.Namespace(uncor=uncor, code=MACKAY, weights=wfile,
                                  sharing=list(SHARING), iters=T, decoding_type=2,
                                  q_bit=5, batch=32, max_rows=0, top=4)
    assert jax_cli._cmd_analyze_uncor(jax_args) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs and "words: 96, still failing:" in ours


def test_cli_convert_weights_writes_jax_bytes(tmp_path, capsys):
    src = bundled_weight_path("wman_N0576_R34_z24_base20")
    out = {}
    for who, run in (("port", lambda s, o: cli.main(["convert-weights", "--src", s,
                                                      "--out", o])),
                     ("jax", lambda s, o: jax_cli._cmd_convert_weights(
                         argparse.Namespace(src=s, out=o)))):
        txt, js = str(tmp_path / f"{who}.txt"), str(tmp_path / f"{who}.json")
        assert run(src, txt) == 0 and run(txt, js) == 0  # JSON -> text -> JSON
        lines = capsys.readouterr().out.replace(str(tmp_path / who), "<out>")
        out[who] = (open(txt, "rb").read(), open(js, "rb").read(), lines)
    assert out["port"] == out["jax"]
    assert out["port"][2].startswith(f"converted {src} -> <out>.txt (sharing (3, 3, 3))")

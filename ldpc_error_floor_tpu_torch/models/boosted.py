"""Boosted two-stage decoding (port of `ldpc_error_floor_tpu/models/boosted.py`).

A *base* decoder handles iterations [0, boundary); a *post* decoder (with
UCN weights) handles [boundary, n_iters) and is trained only on words the
base decoder fails to correct.  At inference the boosted decoder is one deep
NMS decode whose weight rows for the prefix iterations come from the base
stage; `compose_boosted_params` does that composition on tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.codes.protograph import Code
from ldpc_error_floor_tpu_torch.io.weight_files import KINDS
from ldpc_error_floor_tpu_torch.models.nms import (DecodeResult, DecoderConfig,
                                                   NMSDecoder)
from ldpc_error_floor_tpu_torch.models.weights import Params, WeightSpec


def compose_boosted_params(graph: TannerGraph,
                           base_spec: WeightSpec, base_params: Params,
                           post_spec: WeightSpec, post_params: Params) -> Params:
    """Overwrite the first `base_spec.n_iters` weight rows of the post
    decoder's parameters with the base decoder's rows (for every kind both
    have).  Returns new float32 tensors on the post parameters' device."""
    if post_spec.n_iters < base_spec.n_iters:
        raise ValueError("post decoder must be at least as deep as the base")
    out: Params = {}
    for kind in KINDS:
        pv = post_params.get(kind)
        if pv is None:
            out[kind] = None
            continue
        rows = pv.to(torch.float32, copy=True)
        bv = base_params.get(kind)
        if bv is not None:
            upto = min(base_spec.n_iters, base_spec.n_rows(kind),
                       post_spec.n_rows(kind))
            src = bv.to(rows.device, torch.float32)
            base_rows = base_spec.iter_to_row(kind)
            for t in range(upto):
                rows[t] = src[int(base_rows[t])].expand(rows.shape[1])
        out[kind] = rows
    return out


class BoostedDecoder:
    """Base + post two-stage decoder exposed as one deep decode.

    `params` must span the full depth (post-stage parameters with the frozen
    base prefix already composed in — see `compose_boosted_params`).
    """

    def __init__(self, code: Code, cfg: DecoderConfig, spec: WeightSpec,
                 params: Params, boundary: int,
                 graph: Optional[TannerGraph] = None, device="cuda"):
        if not (0 < boundary <= spec.n_iters):
            raise ValueError("boundary must be in (0, n_iters]")
        self.boundary = boundary
        self.decoder = NMSDecoder(code, cfg, spec, graph=graph, device=device)
        self.params = params

    def decode(self, llr: torch.Tensor, labels: Optional[torch.Tensor] = None,
               collect: str = "stats"):
        return self.decoder.decode(self.params, llr, labels=labels, collect=collect)

    def base_failure_mask(self, result: DecodeResult) -> torch.Tensor:
        """[B] bool: frames the base stage (iterations < boundary) never
        corrected — the population the post stage is trained on."""
        if result.err_flags is None:
            raise ValueError("decode with collect='stats' first")
        return torch.all(result.err_flags[: self.boundary], dim=0)

"""Neural min-sum (NMS) decoder (port of `ldpc_error_floor_tpu/models/nms.py`).

`NMSDecoder.decode(params, llr, labels=None, collect='stats')` decodes
``llr [N*z, B]`` (p1/p0 channel LLRs, batch last) for `spec.n_iters`
iterations and returns the final clipped APP plus per-iteration frame-wrong
flags and bit-error counts against the codeword bits ``labels [target*z,
B]`` (None: the all-zero codeword; with ``DecoderConfig.early_stop``, the
genie early stop).  ``collect='deploy'`` stops each word at its first
iteration whose hard decisions satisfy every check (`DeployResult`).
``collect='apps'`` returns the per-iteration APP stack on the target
columns and the last iteration's APP over every bit, differentiable with
respect to the weights (training); `NMSDecoder.apply` is `decode` with that
default, as in the JAX package.  `NMSDecoder.read_totals` decodes the K
batches of a simulator's host read and returns only its genie counters.
The work goes to `ops.fused_decoder.FusedNMSKernel` and, for 'apps',
`ops.fused_train.FusedTrainKernel`: hand-written CUDA kernels for a tensor
on the card, their plain PyTorch versions for a tensor on the CPU, with the
semantics of the JAX scan decoder (labels and ``track_syndrome`` included)
on both.

Sign conventions (as in the JAX package): positive LLR means bit 1; a bit is
wrong when ``APP >= 0``; the check-node sign is
``out_sign = -prod_extrinsic(where(v2c > 0, -1, +1))``; zero V->C messages
are nudged to 1e-4 before the extrinsic min and squashed back after.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.codes.protograph import Code
from ldpc_error_floor_tpu_torch.models.weights import Params, WeightSpec, stack_weights
from ldpc_error_floor_tpu_torch.utils import resolve_device

# decoding types, matching the reference's `decoding_type` codes
SP = 0   # sum-product (tanh/atanh)
MS = 1   # min-sum with zero-message epsilon handling
QMS = 2  # quantized min-sum
MS_RAW = 3  # min-sum without the zero-message epsilon nudge


@dataclass(frozen=True)
class DecoderConfig:
    """Static decoder configuration."""

    decoding_type: int = QMS
    q_bit: int = 5
    clip_llr: float = 20.0
    neural_mode: str = "scale"  # 'scale': multiplicative CN/UCN weights;
    #   'offset': wmag = relu(mag - beta) (neural offset min-sum)
    target_node: int = 0  # >0: count errors over the first `target_node`
    #                        proto columns only (systematic option)
    early_stop: bool = False  # genie early stop of collect='stats': under
    #   QMS each word stops after its own first correct iteration; for the
    #   float states a block of G words once each has decoded correctly at
    #   least once.  The genie-failure mask is exact; the rows after a stop
    #   read 0, so FER_last refers to the stop iteration (ops/fused_decoder.py)
    app_t0: int = 0  # APP emission window of collect='apps' (the JAX
    #   package's pallas_app_t0): only iterations t >= app_t0 are returned,
    #   [T - app_t0, target*z, B].  Legal only under the static eta = 0 loss,
    #   whose cotangents below the window are zero; training sets T-1 then
    track_syndrome: bool = False  # collect='stats' also returns syndrome_ok,
    #   [T, B]: H*x == 0 at iteration t (the fixed-T kernel writes it on the
    #   card).  Not with early_stop

    def __post_init__(self):
        if self.decoding_type not in (SP, MS, QMS, MS_RAW):
            raise ValueError(f"bad decoding_type {self.decoding_type}")
        if self.neural_mode not in ("scale", "offset"):
            raise ValueError(f"bad neural_mode {self.neural_mode!r}")
        if self.app_t0 < 0:
            raise ValueError(f"bad app_t0 {self.app_t0}")
        if self.track_syndrome and self.early_stop:
            raise ValueError("track_syndrome needs every iteration: not with early_stop")


class DecodeResult(NamedTuple):
    app_last: Optional[torch.Tensor]       # [N*z, B] final-iteration APP LLRs (all bits;
    #                                        None under collect='counts')
    err_flags: Optional[torch.Tensor]      # [T, B] bool — frame wrong at iter t
    bit_errors: Optional[torch.Tensor]     # [T, B] int32 — bit errors at iter t
    apps: Optional[torch.Tensor] = None    # [T - app_t0, target*z, B] clipped APPs
    syndrome_ok: Optional[torch.Tensor] = None  # [T, B] bool — H*x == 0 at iter t

    @property
    def uncor_mask(self) -> torch.Tensor:
        """[B] bool — wrong at *every* iteration (the genie-FER failure flag)."""
        return torch.all(self.err_flags, dim=0)


class DeployResult(NamedTuple):
    """Per-word results of a syndrome-stopped ("deploy") decode, each frozen
    at the word's first iteration whose hard decisions satisfy H*x == 0 (or
    at iteration T-1 with `detected_fail` set if none did)."""

    app: torch.Tensor            # [N*z, B] APP LLRs at the stop iteration
    wrong: torch.Tensor          # [B] bool — word wrong at its stop iteration
    bit_errors: torch.Tensor     # [B] int32 — bit errors at its stop iteration
    iters: torch.Tensor          # [B] int32 — iterations executed
    detected_fail: torch.Tensor  # [B] bool — syndrome never satisfied

    @property
    def undetected(self) -> torch.Tensor:
        """[B] bool — converged to a *wrong* codeword (CRC territory)."""
        return self.wrong & ~self.detected_fail


class NMSDecoder:
    """Weighted/neural min-sum decoder over a lifted QC-LDPC Tanner graph."""

    def __init__(self, code: Code, cfg: DecoderConfig, spec: WeightSpec,
                 graph: Optional[TannerGraph] = None, device="cuda"):
        from ldpc_error_floor_tpu_torch.ops.fused_decoder import FusedNMSKernel
        from ldpc_error_floor_tpu_torch.ops.fused_train import FusedTrainKernel
        self.code = code
        self.cfg = cfg
        self.spec = spec
        self.graph = graph if graph is not None else TannerGraph(code)
        self.device = resolve_device(device)
        self.N, self.M, self.z = code.N, code.M, code.z
        self.target = cfg.target_node if cfg.target_node > 0 else self.N
        self.kernel = FusedNMSKernel(self.graph, cfg, spec)
        self.train_kernel = FusedTrainKernel(self.graph, cfg, spec)

    def decode(self, params: Params, llr: torch.Tensor,
               labels: Optional[torch.Tensor] = None, collect: str = "stats"):
        """Run `spec.n_iters` decoding iterations on ``llr [N*z, B]``.

        labels: the codeword bits ``[target*z, B]`` (any dtype; bit 1 where
        ``labels >= 0.5``) that 'stats' and 'deploy' count errors against;
        None is the all-zero codeword.  'apps' and 'app_last' ignore them.

        collect: 'stats' (final APP + per-iteration error flags and
        bit-error counts, and with ``cfg.track_syndrome`` the per-iteration
        syndrome flags), 'counts' ('stats' without the final APP: `app_last`
        None, for a caller that only counts, as the simulator and the
        harvester; on the card the early stop under QMS then writes no APP),
        'app_last' (final APP only), 'deploy' (syndrome
        stop per word; returns a `DeployResult`) or 'apps' (the clipped APPs
        of iterations t >= app_t0 on the target columns, differentiable
        with respect to `params`; `app_last` is then the last iteration's
        clipped APP over every bit, differentiable too, as JAX's scan
        carry: under a systematic target more rows than ``apps[-1]``).
        """
        if collect not in ("stats", "counts", "app_last", "deploy", "apps"):
            raise ValueError(f"bad collect {collect!r}")
        if llr.device.type != self.device.type:
            raise ValueError(f"llr on {llr.device}, decoder on {self.device}")
        stacked = stack_weights(self.spec, params)
        if collect == "deploy":
            return DeployResult(*self.kernel.decode_deploy(stacked, llr, labels))
        if collect == "apps":
            apps, app_last = self.train_kernel.apps_and_last(stacked, llr)
            return DecodeResult(app_last, None, None, apps)
        if collect == "app_last":
            return DecodeResult(self.kernel.decode_stats(stacked, llr)[0], None, None)
        app, err, nerr, *synd = self.kernel.decode_stats(stacked, llr, labels,
                                                         app=collect == "stats")
        return DecodeResult(app, err, nerr, None, *synd)

    def read_totals(self, params: Params, llr_read: torch.Tensor) -> torch.Tensor:
        """The genie counters of K batches ``llr_read [K, N*z, B]`` against
        the all-zero word, int64 [3] on its device: bit errors and frames
        wrong at the last iteration, frames wrong at every iteration, summed
        over the K*B words, as 'counts' rows reduce to them
        (`FusedNMSKernel.decode_read_totals`)."""
        if llr_read.device.type != self.device.type:
            raise ValueError(f"llr on {llr_read.device}, decoder on {self.device}")
        return self.kernel.decode_read_totals(stack_weights(self.spec, params), llr_read)

    def apply(self, params: Params, llr: torch.Tensor,
              labels: Optional[torch.Tensor] = None, collect: str = "apps"):
        """`decode` with the JAX package's default for composing into a
        training step: ``collect='apps'``."""
        return self.decode(params, llr, labels, collect)

"""BPSK + AWGN channel sampling on the device (port of
`ldpc_error_floor_tpu/channel/awgn.py`).

* all-zero codeword (`sample`) or explicit codeword bits
  (`sample_codewords`, paired with `codes.encoder.Encoder`); BPSK maps
  bit b -> (-1)^(1-b), so bit 0 -> -1;
* LLR = 2y/sigma^2 in the p1/p0 convention (positive LLR asserts bit 1);
* optional channel-LLR quantization for QMS;
* punctured bits get LLR 0 (0.001 for sum-product), shortened bits get
  -clip_llr (asserting bit 0);
* SNR-mix batching: the per-word sigma cycles through an SNR list.

Noise comes from an explicit `torch.Generator` on the channel's device, so
it is not the JAX package's noise; `_llr` keeps the JAX operation order, so
the same noise gives the same LLRs bit for bit.  LLRs are ``[N*z, B]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.protograph import Code
from ldpc_error_floor_tpu_torch.models.nms import QMS, SP
from ldpc_error_floor_tpu_torch.ops.ste import quantize_llr
from ldpc_error_floor_tpu_torch.utils import resolve_device


def mix_sigma_lanes(sigmas: Sequence[float], batch: int) -> np.ndarray:
    """Per-word sigma cycling through the SNR list (reference's mix epochs)."""
    s = np.asarray(sigmas, np.float32)
    return np.tile(s, batch // len(s) + 1)[:batch]


class AWGNChannel:
    """Zero-codeword BPSK+AWGN LLR sampler for a given code."""

    def __init__(self, code: Code, decoding_type: int = QMS, q_bit: int = 5,
                 clip_llr: float = 20.0, device="cuda"):
        self.code = code
        self.decoding_type = decoding_type
        self.q_bit = q_bit
        self.clip_llr = clip_llr
        self.device = resolve_device(device)
        bit_idx = np.arange(1, code.n_full + 1)  # 1-indexed bit positions
        ps, pe = code.punct
        ss, se = code.short
        mask = lambda lo, hi: torch.as_tensor(
            ((bit_idx >= lo) & (bit_idx <= hi) & (lo > 0)).astype(np.float32),
            device=self.device)[:, None]
        self._punct = mask(ps, pe)
        self._short = mask(ss, se)

    def sample(self, generator: torch.Generator,
               sigma_lanes: torch.Tensor) -> torch.Tensor:
        """Sample a batch of channel LLRs [N*z, B]; sigma_lanes is [B]."""
        noise = torch.randn((self.code.n_full, sigma_lanes.shape[0]),
                            generator=generator, dtype=torch.float32,
                            device=self.device)
        y = -1.0 + noise * sigma_lanes[None, :]          # all-zero word, BPSK -1
        return self._llr(y, sigma_lanes)

    def sample_codewords(self, generator: torch.Generator,
                         sigma_lanes: torch.Tensor,
                         bits: torch.Tensor) -> torch.Tensor:
        """Channel LLRs [N*z, B] for codeword bits [N*z, B] in {0, 1}."""
        noise = torch.randn((self.code.n_full, sigma_lanes.shape[0]),
                            generator=generator, dtype=torch.float32,
                            device=self.device)
        s = 2.0 * bits.float() - 1.0                      # bit b -> (-1)^(1-b)
        y = s + noise * sigma_lanes[None, :]
        return self._llr(y, sigma_lanes)

    def _llr(self, y: torch.Tensor, sigma_lanes: torch.Tensor) -> torch.Tensor:
        llr = 2.0 * y / (sigma_lanes[None, :] ** 2)       # p1/p0 LLR
        if self.decoding_type == QMS:
            llr = quantize_llr(llr, self.q_bit)
        punct_val = 0.001 if self.decoding_type == SP else 0.0
        llr = llr * (1.0 - self._punct) + punct_val * self._punct
        llr = llr * (1.0 - self._short) + (-self.clip_llr) * self._short
        return llr

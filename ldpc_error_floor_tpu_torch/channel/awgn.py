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
it is not the JAX package's noise; `llr_plain` keeps the JAX operation
order, so the same noise gives the same LLRs bit for bit.  LLRs are
``[N*z, B]``.

On the card everything after `torch.randn` is one launch of the
`ops/awgn_llr.py` kernel (`csrc/awgn_llr.cu`), as the JAX step computes it
in one XLA fusion; `llr_plain` is the plain version it is held to, which
the CPU runs.  `launches` counts the kernel's launches; a launch made while
the current stream is captured into a CUDA graph counts in `captured`, and
the graph's owner adds it to `launches` at each replay (`sim/fer.py`).
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.protograph import Code
from ldpc_error_floor_tpu_torch.models.nms import QMS, SP
from ldpc_error_floor_tpu_torch.ops import awgn_llr
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
        self.llr_params = awgn_llr.llr_params(code, decoding_type, q_bit, clip_llr)
        self.launches: collections.Counter = collections.Counter()
        self.captured: collections.Counter = collections.Counter()

    def _noise(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        return torch.randn((self.code.n_full, batch), generator=generator,
                           dtype=torch.float32, device=self.device)

    def sample(self, generator: torch.Generator, sigma_lanes: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample a batch of channel LLRs [N*z, B]; sigma_lanes is [B].
        `out`: the [N*z, B] tensor to write them into (as in `llr`)."""
        return self.llr(self._noise(generator, sigma_lanes.shape[0]), sigma_lanes,
                        out=out)

    def sample_codewords(self, generator: torch.Generator,
                         sigma_lanes: torch.Tensor, bits: torch.Tensor,
                         fold: bool = False,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Channel LLRs [N*z, B] for codeword bits [N*z, B] in {0, 1}; with
        `fold`, sign-folded to the zero word (``llr * (1 - 2*bits)``)."""
        return self.llr(self._noise(generator, sigma_lanes.shape[0]), sigma_lanes,
                        bits, fold, out)

    def llr(self, noise: torch.Tensor, sigma_lanes: torch.Tensor,
            bits: Optional[torch.Tensor] = None, fold: bool = False,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The LLRs of `noise` [N*z, B]: one launch of the kernel for a
        tensor on the card, `llr_plain` for a tensor on the CPU; written
        into `out` where one is given (the kernel writes there itself), else
        into a new tensor."""
        if noise.device.type == "cpu":
            llr = self.llr_plain(noise, sigma_lanes, bits, fold)
            return llr if out is None else out.copy_(llr)
        if bits is not None:
            bits = bits.to(torch.float32)
        out = awgn_llr.launch(self.llr_params, noise, sigma_lanes, bits, fold, out)
        if torch.cuda.is_current_stream_capturing():
            self.captured[awgn_llr.KERNEL] += 1
        else:
            self.launches[awgn_llr.KERNEL] += 1
        return out

    def llr_plain(self, noise: torch.Tensor, sigma_lanes: torch.Tensor,
                  bits: Optional[torch.Tensor] = None,
                  fold: bool = False) -> torch.Tensor:
        """The plain PyTorch version of the kernel, on any device: the JAX
        package's `sample` (all-zero word) or `sample_codewords` body after
        the noise, and with `fold` the sign fold of its random-codeword
        step."""
        if bits is None:
            y = -1.0 + noise * sigma_lanes[None, :]          # all-zero word, BPSK -1
        else:
            s = 2.0 * bits.float() - 1.0                      # bit b -> (-1)^(1-b)
            y = s + noise * sigma_lanes[None, :]
        llr = self._llr(y, sigma_lanes)
        if fold:
            llr = llr * (1.0 - 2.0 * bits)
        return llr

    def _llr(self, y: torch.Tensor, sigma_lanes: torch.Tensor) -> torch.Tensor:
        llr = 2.0 * y / (sigma_lanes[None, :] ** 2)       # p1/p0 LLR
        if self.decoding_type == QMS:
            llr = quantize_llr(llr, self.q_bit)
        punct_val = 0.001 if self.decoding_type == SP else 0.0
        llr = llr * (1.0 - self._punct) + punct_val * self._punct
        llr = llr * (1.0 - self._short) + (-self.clip_llr) * self._short
        return llr

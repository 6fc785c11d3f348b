"""The channel sampler's LLR pass (S1): its CUDA kernel, the kernel's
launch parameters and the launch.

`csrc/awgn_llr.cu` computes, from the `randn` noise of one batch, what
`channel/awgn.py::AWGNChannel.llr_plain` computes (the BPSK mapping,
2y/sigma^2, the QMS grid, the punctured and shortened rows and the
random-codeword fold) in one pass that reads the noise once and writes the
LLRs once, bit-equal to it.  It replaces the elementwise XLA fusion of
`ldpc_error_floor_tpu/channel/awgn.py:61-89` and
`ldpc_error_floor_tpu/sim/fer.py:166` inside the JAX step.  It is built
with nvcc at first use (`ops/fused_decoder.py::build_library`) and bound
with ctypes; `AWGNChannel.llr` launches it for a tensor on the card and
counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ldpc_error_floor_tpu_torch.codes.protograph import Code
from ldpc_error_floor_tpu_torch.models.nms import QMS, SP
from ldpc_error_floor_tpu_torch.ops import fused_decoder as fd
from ldpc_error_floor_tpu_torch.ops.ste import qms_grid

KERNEL = "awgn_llr"  # the name its launches count under
_SRC = fd._SRC.parent / "awgn_llr.cu"


@functools.lru_cache(maxsize=None)
def load_library() -> Tuple[ctypes.CDLL, str]:
    """Build `csrc/awgn_llr.cu` (once per source hash) into the decode
    kernel's build directory and load it; the library and ptxas' log."""
    lib, log = fd.build_library(_SRC)
    fn = lib.awgn_llr_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, log


def row_range(lo: int, hi: int) -> Tuple[int, int]:
    """A code's 1-indexed inclusive bit range (``code.punct``, ``code.short``;
    lo = 0: none) as 0-indexed half-open rows."""
    return (lo - 1, hi) if lo > 0 else (0, 0)


@dataclass(frozen=True)
class LLRParams:
    """The kernel's scalars for one channel configuration."""
    quantize: bool
    step: float
    clip: float
    punct_val: float
    punct_rows: Tuple[int, int]
    short_rows: Tuple[int, int]
    clip_llr: float


def llr_params(code: Code, decoding_type: int, q_bit: int, clip_llr: float) -> LLRParams:
    """The launch parameters `AWGNChannel.llr_plain` implies: the QMS grid
    (QMS only), 0.001 on punctured rows under SP (else 0) and the two row
    ranges, as the channel's masks derive them."""
    quantize = decoding_type == QMS
    step, clip = qms_grid(q_bit) if quantize else (1.0, 0.0)
    return LLRParams(quantize, step, clip, 0.001 if decoding_type == SP else 0.0,
                     row_range(*code.punct), row_range(*code.short), clip_llr)


def launch(prm: LLRParams, noise: torch.Tensor, sigma: torch.Tensor,
           bits: Optional[torch.Tensor] = None, fold: bool = False,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch on the card: LLRs [R, B] float32 from noise [R, B] and
    sigma [B] (and codeword bits [R, B]), on the current stream, into `out`
    (a new tensor when None); raises for inputs the kernel does not take
    and for a failed launch."""
    if noise.device.type != "cuda":
        raise ValueError(f"the awgn_llr kernel runs on the card, not {noise.device}")
    if noise.dtype != torch.float32 or noise.dim() != 2 or not noise.is_contiguous():
        raise ValueError("noise must be a contiguous float32 [R, B] tensor")
    R, B = noise.shape
    if (sigma.dtype != torch.float32 or sigma.shape != (B,) or not sigma.is_contiguous()
            or sigma.device != noise.device):
        raise ValueError(f"sigma must be a contiguous float32 [{B}] tensor on {noise.device}")
    if bits is not None and (bits.dtype != torch.float32 or bits.shape != noise.shape
                             or not bits.is_contiguous() or bits.device != noise.device):
        raise ValueError(f"bits must be a contiguous float32 [{R}, {B}] tensor "
                         f"on {noise.device}")
    if fold and bits is None:
        raise ValueError("the fold needs the codeword bits")
    if out is None:
        out = torch.empty_like(noise)
    elif (out.dtype != torch.float32 or out.shape != noise.shape or not out.is_contiguous()
          or out.device != noise.device):
        raise ValueError(f"out must be a contiguous float32 [{R}, {B}] tensor "
                         f"on {noise.device}")
    lib, _ = load_library()
    with torch.cuda.device(noise.device):
        rc = lib.awgn_llr_launch(
            noise.data_ptr(), sigma.data_ptr(), None if bits is None else bits.data_ptr(),
            out.data_ptr(), R, B, int(prm.quantize), prm.step, prm.clip, prm.punct_val,
            *prm.punct_rows, *prm.short_rows, -prm.clip_llr, int(fold),
            torch.cuda.current_stream(noise.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"awgn_llr_launch failed: CUDA error {rc}")
    return out

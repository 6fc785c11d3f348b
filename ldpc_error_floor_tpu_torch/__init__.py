"""ldpc_error_floor_tpu_torch — the PyTorch/CUDA port of ldpc_error_floor_tpu.

Neural min-sum LDPC decoding for one NVIDIA H100: the same codes, weight
files and decoder semantics as the JAX package, with the hot loop in a
hand-written CUDA kernel (`csrc/`).  Entry points take ``device=`` and run
on the card unless the caller passes ``device="cpu"``, which runs the plain
PyTorch version of each kernel.  This package imports neither JAX nor the
JAX package.
"""

__version__ = "0.1.0"

from ldpc_error_floor_tpu_torch.codes import Code, TannerGraph, load_proto_matrix
from ldpc_error_floor_tpu_torch.models import DecoderConfig, NMSDecoder

__all__ = [
    "Code",
    "TannerGraph",
    "load_proto_matrix",
    "DecoderConfig",
    "NMSDecoder",
    "__version__",
]

"""Device selection shared by the port's entry points, and the tracing
helpers (`utils/profiling.py`)."""

from __future__ import annotations

import torch

from ldpc_error_floor_tpu_torch.utils.profiling import annotate, snapshot, trace


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point's `device=` argument.

    The port runs on the card unless the caller asks for the CPU; a CUDA
    device that is not there is an error, never a silent switch to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


__all__ = ["resolve_device", "trace", "annotate", "snapshot"]

"""QMS quantizer grids, forward only (port of `ldpc_error_floor_tpu/ops/ste.py`).

Grids (step, clip): q=6 -> (1, 15.5); q=5 -> (0.5, 7.5); q=-5 -> (1, 15);
q=4 -> (1, 7); q=3 -> (2, 6).  `torch.round` rounds half to even, as
`jnp.round` does, so grid ties land on the same value in both packages.
The straight-through gradients come with training.
"""

from __future__ import annotations

import torch

_GRIDS = {6: (1.0, 15.5), 5: (0.5, 7.5), -5: (1.0, 15.0), 4: (1.0, 7.0), 3: (2.0, 6.0)}


def qms_grid(q_bit: int):
    if q_bit not in _GRIDS:
        raise ValueError(f"unsupported q_bit {q_bit}; supported: {sorted(_GRIDS)}")
    return _GRIDS[q_bit]


def qms_clip_limit(q_bit: int) -> float:
    return qms_grid(q_bit)[1]


def quantize_llr(x: torch.Tensor, q_bit: int) -> torch.Tensor:
    """Round to the grid, then clip: ``clip(round(x / step) * step)``."""
    step, clip = qms_grid(q_bit)
    return torch.clamp(torch.round(x / step) * step, -clip, clip)

"""QMS quantizer grids and the straight-through surrogates (port of
`ldpc_error_floor_tpu/ops/ste.py`).

Grids (step, clip): q=6 -> (1, 15.5); q=5 -> (0.5, 7.5); q=-5 -> (1, 15);
q=4 -> (1, 7); q=3 -> (2, 6).  `torch.round` rounds half to even, as
`jnp.round` does, so grid ties land on the same value in both packages.

The straight-through functions use the JAX package's construction
``lin + (q - lin).detach()``: the forward value is the quantized (clipped)
one, the gradient is 1 inside the clip INCLUSIVE and 0 outside.  On the grid
``lin + (q - lin)`` equals ``q`` exactly (q - x is exact for x within half a
step of q), so a tensor that needs no gradient takes the plain formula and
gets the same values.
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


def clip_tf_grad(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip with TensorFlow's `clip_by_value` gradient: 1 for lo <= x <= hi
    INCLUSIVE, 0 outside."""
    clipped = torch.clamp(x, lo, hi)
    if not x.requires_grad:
        return clipped
    lin = x * ((x >= lo) & (x <= hi)).to(x.dtype)
    return lin + (clipped - lin).detach()


def quantize_ste(x: torch.Tensor, q_bit: int) -> torch.Tensor:
    """STE quantizer: forward round-to-grid + clip, backward identity inside
    [-clip, clip] inclusive, zero outside."""
    q = quantize_llr(x, q_bit)
    if not x.requires_grad:
        return q
    lin = x * (x.abs() <= qms_grid(q_bit)[1]).to(x.dtype)
    return lin + (q - lin).detach()


def inv_exp(x: torch.Tensor) -> torch.Tensor:
    """Smooth sign surrogate 2*sigmoid(x) - 1 (the reference's `inv_exp`)."""
    return 2.0 * torch.sigmoid(x) - 1.0


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """Forward sign(x); backward the gradient of `inv_exp` (the reference's
    `sign_through`, used by the soft-FER loss)."""
    surrogate = inv_exp(x)
    return surrogate + (torch.sign(x) - surrogate).detach()

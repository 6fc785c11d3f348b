"""Multi-iteration training losses with STE surrogates (port of
`ldpc_error_floor_tpu/training/losses.py`).

* the loss sums per-iteration terms for t in [t_start, T) weighted by
  eta^(T-1-t), with the convention 0^0 = 1 (eta = 0 means last iteration
  only), normalized by the sum of the coefficients;
* loss_type 0 — BCE with logits against the label bits, in softplus form
  (its gradient is sigmoid(APP) - label everywhere, APP = 0 included);
* loss_type 1 — soft BER: mean sigmoid(APP) (all-zero word);
* loss_type 2 — soft FER: 1/2 (1 - sign_ste(min over bits of -APP)), whose
  backward is the `inv_exp` surrogate's (all-zero word).  `torch.amin`
  splits the min's gradient equally among ties, as JAX's min does.

A window that holds no iteration (``t_start > T - 1``) raises: its
normalizer would be 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ldpc_error_floor_tpu_torch.ops.ste import sign_ste

BCE = 0
SOFT_BER = 1
SOFT_FER = 2


def _last_iteration_loss(app: torch.Tensor, labels: torch.Tensor,
                         loss_type: int) -> torch.Tensor:
    if loss_type == BCE:
        return torch.mean(F.softplus(app) - app * labels.float())
    if loss_type == SOFT_BER:
        return torch.mean(torch.sigmoid(app))
    if loss_type == SOFT_FER:
        worst = torch.amin(-app, dim=0)
        return torch.mean(0.5 * (1.0 - sign_ste(worst)))
    raise ValueError(f"bad loss_type {loss_type}")


def multi_iteration_loss(apps: torch.Tensor, labels: torch.Tensor,
                         loss_type: int, etha, t_start: int = 0) -> torch.Tensor:
    """apps: [T, target*z, B] per-iteration APP LLRs; labels: [target*z, B].

    A Python ``etha == 0.0`` takes the last-iteration-only path (0^0 = 1,
    every other coefficient 0, normalizer 1), equal to the general path's
    value; a tensor `etha` takes the general path."""
    T = apps.shape[0]
    if not 0 <= t_start <= T - 1:
        raise ValueError(f"loss window t_start={t_start} holds no iteration "
                         f"of {T}")
    if loss_type not in (BCE, SOFT_BER, SOFT_FER):
        raise ValueError(f"bad loss_type {loss_type}")
    if isinstance(etha, float) and etha == 0.0:
        return _last_iteration_loss(apps[T - 1], labels, loss_type)
    tt = torch.arange(T, device=apps.device)
    expo = (T - 1 - tt).float()
    etha = torch.as_tensor(etha, dtype=torch.float32, device=apps.device)
    coeff = torch.where(expo == 0.0, torch.ones_like(expo), etha ** expo)
    coeff = coeff * (tt >= t_start).float()

    if loss_type == BCE:
        per_elem = F.softplus(apps) - apps * labels.float()[None]
        per_t = torch.mean(per_elem, dim=(1, 2))
    elif loss_type == SOFT_BER:
        per_t = torch.mean(torch.sigmoid(apps), dim=(1, 2))
    else:
        worst = torch.amin(-apps, dim=1)            # [T, B]; < 0 iff a bit is wrong
        per_t = torch.mean(0.5 * (1.0 - sign_ste(worst)), dim=1)
    return torch.sum(coeff * per_t) / torch.sum(coeff)

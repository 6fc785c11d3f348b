"""Plain reference of the block-wise training step: the unrolled QMS
decode as a differentiable network, the soft-FER loss, Adam and the box
clip, in float32 PyTorch with autograd.

It imports nothing of the program.  The semantics follow the published
training recipe (arXiv:2310.07194; the upstream `Main_Functions.py`,
`Print_Functions.py`), as TensorFlow differentiates it:

* the quantizers and the clips pass the gradient straight through inside
  their bounds, bounds included, and block it outside (`tf.clip_by_value`);
* |x| has gradient +1 at 0; a zero V->C message is nudged to 1e-4;
* each check's extrinsic minimum is `tf.reduce_min` over the other slots,
  whose gradient is split equally among the slots that attain it;
* the soft FER of a word is 1/2 (1 - sign(min over bits of -APP)), whose
  sign passes the gradient of 2 sigmoid(x) - 1; the loss is its mean over
  the batch at the last iteration;
* Adam (beta 0.9, 0.999, eps 1e-8), then every weight clipped to
  [min_w, max_w].

The weights here are one per iteration or one per proto row (CN) and
column (VN); UCN weights are not trained by the recipe and not taken.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.decode import GRIDS, RefCode

EPS_MSG = 1e-4


def _quantize(x: torch.Tensor, step: float, clip: float) -> torch.Tensor:
    q = torch.clamp(torch.round(x / step) * step, -clip, clip)
    lin = x * (x.abs() <= clip).to(x.dtype)
    return lin + (q - lin).detach()


def _clip(x: torch.Tensor, lim: float) -> torch.Tensor:
    c = torch.clamp(x, -lim, lim)
    lin = x * (x.abs() <= lim).to(x.dtype)
    return lin + (c - lin).detach()


def _abs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, -x)


def _sign_ste(x: torch.Tensor) -> torch.Tensor:
    s = 2.0 * torch.sigmoid(x) - 1.0
    return s + (torch.sign(x) - s).detach()


class _OthersMin(torch.autograd.Function):
    """out[k] = min over slots j != k of a[j], along dim 0; the gradient of
    each out[k] is split equally among the slots j != k that attain it."""

    @staticmethod
    def forward(ctx, a):
        d = a.shape[0]
        other = ~torch.eye(d, dtype=torch.bool, device=a.device).view(d, d, *([1] * (a.dim() - 1)))
        big = torch.finfo(a.dtype).max
        cand = torch.where(other, a.unsqueeze(0), big)           # [k, j, ...]
        out = cand.amin(dim=1)
        ctx.save_for_backward(a, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, out = ctx.saved_tensors
        d = a.shape[0]
        other = ~torch.eye(d, dtype=torch.bool, device=a.device).view(d, d, *([1] * (a.dim() - 1)))
        hit = other & (a.unsqueeze(0) == out.unsqueeze(1))        # [k, j, ...]
        share = g / hit.sum(dim=1).to(g.dtype)
        return (hit.to(g.dtype) * share.unsqueeze(1)).sum(dim=0)


class RefTrainer:
    """The training step of the module docstring for one code and block.

    `weights`: {"cn": [T, 1 or M], "vn": [T, 1 or N]} float32 starting rows;
    every row is trained (the block [0, T))."""

    def __init__(self, code: RefCode, weights: Dict[str, np.ndarray], n_iters: int,
                 q_bit: int, clip_llr: float, lr: float, min_w: float, max_w: float,
                 device, chunk: int = 4096):
        self.code, self.T, self.clip_llr, self.dev = code, n_iters, clip_llr, torch.device(device)
        self.step_q, self.clip_q = GRIDS[q_bit]
        self.lr, self.min_w, self.max_w, self.chunk = lr, min_w, max_w, chunk
        z = code.z
        rows = code.rows_of()
        self.groups = []
        edge_bit: List[int] = []
        for d in sorted({len(r) for r in rows}):
            rset = [i for i in range(code.M) if len(rows[i]) == d]
            start = len(edge_bit)
            for k in range(d):
                for i in rset:
                    j, s = rows[i][k]
                    edge_bit.extend(j * z + (h + s) % z for h in range(z))
            row_of = torch.as_tensor(np.repeat(rset, z), device=self.dev)
            self.groups.append((start, len(edge_bit), len(rset) * z, d, row_of))
        self.E = len(edge_bit)
        self.edge_bit = torch.as_tensor(edge_bit, device=self.dev)
        self.col_of_bit = torch.as_tensor(np.repeat(np.arange(code.N), z), device=self.dev)
        self.params = {k: torch.tensor(np.asarray(v, np.float32), device=self.dev)
                       for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0

    def llr(self, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """Quantized channel LLRs [N*z, B] of the all-zero word, sigma per word."""
        y = -1.0 + noise * sigma[None, :]
        llr = 2.0 * y / (sigma[None, :] ** 2)
        return torch.clamp(torch.round(llr / self.step_q) * self.step_q,
                           -self.clip_q, self.clip_q)

    def _per(self, w: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        return w[:, :1].expand(-1, index.numel()) if w.shape[1] == 1 else w[:, index]

    def loss(self, llr: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean soft FER of the last iteration's APP over the words of `llr`."""
        q = lambda x: _quantize(x, self.step_q, self.clip_q)
        n, nz = llr.shape[1], self.code.n_full
        w_vn = self._per(params["vn"], self.col_of_bit)[:, :, None]       # [T, Nz, 1]
        w_cn = [self._per(params["cn"], row_of)[:, :, None] for *_, row_of in self.groups]
        llr_app = q(llr)
        c2v = torch.zeros((self.E, n), device=self.dev)
        total = torch.zeros((nz, n), device=self.dev)
        for t in range(self.T):
            chan = q(llr * w_vn[t])
            v2c = q((chan + total)[self.edge_bit] - c2v)
            v2c = v2c + EPS_MSG * (v2c == 0).to(v2c.dtype)
            outs = []
            for g, (lo, hi, rz, d, _) in enumerate(self.groups):
                x = v2c[lo:hi].view(d, rz, n)
                sgn = torch.where(x > 0, -1.0, 1.0)
                mag = _OthersMin.apply(_abs(x))
                mag = torch.where(mag.abs() <= EPS_MSG, mag - EPS_MSG, mag)
                out = mag * (-(torch.prod(sgn, dim=0, keepdim=True) * sgn))
                wmag = mag * w_cn[g][t]
                wmag = q(wmag * (wmag > 0).to(wmag.dtype))
                outs.append((wmag * torch.sign(out)).reshape(-1, n))
            c2v = torch.cat(outs)
            total = torch.zeros((nz, n), device=self.dev).index_add(0, self.edge_bit, c2v)
        app = _clip(llr_app + total, self.clip_llr)
        worst = torch.amin(-app, dim=0)
        return torch.mean(0.5 * (1.0 - _sign_ste(worst)))

    def step(self, noise: torch.Tensor, sigma: torch.Tensor) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One Adam step on a batch: (the batch's loss, the gradient)."""
        B = noise.shape[1]
        params = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
        total_loss = 0.0
        for lo in range(0, B, self.chunk):
            part = self.loss(self.llr(noise[:, lo:lo + self.chunk], sigma[lo:lo + self.chunk]),
                             params)
            scaled = part * (min(self.chunk, B - lo) / B)
            scaled.backward()
            total_loss += float(scaled.detach())
        grads = {k: p.grad.detach() for k, p in params.items()}
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                p = self.params[k] - self.lr * m_hat / (v_hat.sqrt() + eps)
                self.params[k] = torch.clamp(p, self.min_w, self.max_w)
        return total_loss, grads

"""GF(2) systematic encoder for the lifted code (port of
`ldpc_error_floor_tpu/codes/encoder.py`).

A reduced-row-echelon decomposition of the lifted parity-check matrix H
(with unit rows pinning the shortened bits to zero) gives a systematic map
from k = n - rank free message bits to full codewords.  Encoding is one
GF(2) product on the device: a float64 matmul followed by mod 2, exact for
any k here and untouched by TF32 settings.  Used by random-codeword
Monte-Carlo (`sim/fer.py`, ``codewords='random'``).
"""

from __future__ import annotations

from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.utils import resolve_device


def gf2_rref(H: np.ndarray) -> Tuple[np.ndarray, list]:
    """Reduced row-echelon form of a binary matrix over GF(2).

    Returns (R [rank, n] uint8, pivot column list)."""
    A = (np.asarray(H) % 2).astype(np.uint8).copy()
    m, n = A.shape
    pivots = []
    r = 0
    for c in range(n):
        if r == m:
            break
        rows = np.nonzero(A[r:, c])[0]
        if len(rows) == 0:
            continue
        p = r + int(rows[0])
        if p != r:
            A[[r, p]] = A[[p, r]]
        elim = np.nonzero(A[:, c])[0]
        elim = elim[elim != r]
        if len(elim):
            A[elim] ^= A[r]
        pivots.append(c)
        r += 1
    return A[:r], pivots


class Encoder:
    """Systematic GF(2) encoder over a lifted Tanner graph's H, on `device`."""

    def __init__(self, graph: TannerGraph, device="cuda"):
        self.graph = graph
        self.code = graph.code
        self.device = resolve_device(device)
        n = self.code.n_full
        H = graph.H
        # shortened bits are known-zero in every transmitted word: pin them
        # to pivots with unit rows, so k is the shortened code's dimension
        ss, se = self.code.short
        if ss > 0:
            rows = np.zeros((se - ss + 1, n), np.uint8)
            rows[np.arange(se - ss + 1), np.arange(ss - 1, se)] = 1
            H = np.vstack([H.astype(np.uint8), rows])
        R, pivots = gf2_rref(H)
        self.rank = len(pivots)
        self.k = n - self.rank
        piv = np.asarray(pivots, np.int64)
        free = np.setdiff1d(np.arange(n, dtype=np.int64), piv)
        self._piv = torch.as_tensor(piv, device=self.device)
        self._free = torch.as_tensor(free, device=self.device)
        # x_piv = S @ x_free (mod 2), from the RREF rows
        self._S = torch.as_tensor(R[:, free].astype(np.float64),
                                  device=self.device)

    def encode(self, msgs: torch.Tensor) -> torch.Tensor:
        """msgs [k, B] in {0,1} -> codeword bits [n_full, B] float32 in {0,1}."""
        m = msgs.double()
        xp = torch.remainder(self._S @ m, 2.0)
        x = torch.zeros((self.code.n_full, msgs.shape[-1]), dtype=torch.float32,
                        device=self.device)
        x[self._free] = m.float()
        x[self._piv] = xp.float()
        return x

    def random_messages(self, generator: torch.Generator,
                        batch: int) -> torch.Tensor:
        return torch.randint(0, 2, (self.k, batch), generator=generator,
                             device=self.device).float()

    def random_codewords(self, generator: torch.Generator,
                         batch: int) -> torch.Tensor:
        return self.encode(self.random_messages(generator, batch))

    @cached_property
    def _H_dev(self) -> torch.Tensor:
        return torch.as_tensor(self.graph.H.astype(np.float64), device=self.device)

    def syndrome_ok(self, bits: torch.Tensor) -> torch.Tensor:
        """[B] bool — H*bits == 0."""
        return (torch.remainder(self._H_dev @ bits.double(), 2.0) == 0.0).all(dim=0)

"""Failure analysis: classify harvested uncorrected words by trapping-set
signature (port of `ldpc_error_floor_tpu/sim/analysis.py`).

Harvested `[Uncor]` rows are decoded once more with any weight set and
every word that still fails is classified:

* **(a, b) class**: a = Hamming weight of the final hard-decision error
  pattern (against the all-zero codeword), b = unsatisfied-check count;
  oscillating (non-fixed-point) failures show large a;
* **support statistics**: how often each variable node lies in a failing
  word's error support (trapping sets recur on the same few places).

The decode is `NMSDecoder.apply(collect='stats')`: on the card the fixed-T
kernel (the genie early stop under ``early_stop``), one launch per batch;
the classification is NumPy over the graph's H.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import Params


@dataclass
class FailureReport:
    total_words: int
    still_failing: int
    rescued: int
    # (a, b) -> count over still-failing words
    classes: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # variable-node index -> number of failing words whose error support
    # contains it
    vn_hits: Optional[np.ndarray] = None

    @property
    def top_classes(self) -> List[Tuple[Tuple[int, int], int]]:
        return sorted(self.classes.items(), key=lambda kv: -kv[1])

    def summary(self, k: int = 10) -> str:
        lines = [f"words: {self.total_words}, still failing: "
                 f"{self.still_failing}, rescued: {self.rescued} "
                 f"({self.rescued / max(self.total_words, 1):.1%})",
                 "top (a=wrong bits, b=unsat checks) classes:"]
        for (a, b), n in self.top_classes[:k]:
            lines.append(f"  ({a:3d},{b:3d}): {n}")
        if self.vn_hits is not None and self.still_failing:
            top = np.argsort(-self.vn_hits)[:k]
            lines.append("most-hit variable nodes (bit index: words):")
            lines.append("  " + ", ".join(
                f"{int(i)}:{int(self.vn_hits[i])}" for i in top
                if self.vn_hits[i] > 0))
        return "\n".join(lines)


def classify_failures(decoder: NMSDecoder, params: Params,
                      llr_rows: np.ndarray, batch: int = 1024,
                      track_supports: bool = True) -> FailureReport:
    """Decode harvested LLR rows ``[num, N*z]`` (p1/p0, all-zero truth) and
    classify every still-failing word by its final (a, b) signature.

    As in the JAX package, only whole batches are decoded: the first
    ``(num // batch) * batch`` rows, so up to ``batch - 1`` trailing rows
    are dropped and `total_words` counts the rows decoded; fewer rows than
    one batch are decoded as one smaller batch."""
    H = decoder.graph.H.astype(np.int8)
    nz = decoder.code.n_full
    n = (llr_rows.shape[0] // batch) * batch or llr_rows.shape[0]
    classes: Counter = Counter()
    vn_hits = np.zeros(nz, np.int64) if track_supports else None
    failing = 0
    for lo in range(0, n, batch):
        chunk = np.ascontiguousarray(llr_rows[lo:lo + batch].T, np.float32)
        res = decoder.apply(params, torch.as_tensor(chunk, device=decoder.device),
                            collect="stats")
        uncor = res.uncor_mask.cpu().numpy()
        bits = (res.app_last >= 0).to(torch.int8).cpu().numpy()  # [N*z, B]
        for col in np.nonzero(uncor)[0]:
            e = bits[:, col]
            a = int(e.sum())
            b = int(((H @ e) % 2).sum())
            classes[(a, b)] += 1
            failing += 1
            if vn_hits is not None:
                vn_hits += e.astype(np.int64)
    return FailureReport(total_words=n, still_failing=failing,
                         rescued=n - failing, classes=dict(classes),
                         vn_hits=vn_hits)

"""Uncorrected-word dataset I/O (port of
`ldpc_error_floor_tpu/io/uncor_files.py`, its NumPy path).

Tab-separated text, one row per harvested frame: 3 metadata columns (zeros
on write, dropped on read), then the N*z *negated* channel LLRs, written
'%.1f' (negating on read restores the p1/p0 convention).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_uncor_file(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """Read harvested LLRs; returns [num_frames, N*z] float32 in p1/p0 LLRs."""
    data = np.loadtxt(path, dtype=np.float32, delimiter="\t")
    if data.ndim == 1:
        data = data[None, :]
    data = -data[:, 3:]  # drop metadata columns; stored negated
    if max_rows is not None:
        if data.shape[0] < max_rows:
            raise ValueError(
                f"{path}: has {data.shape[0]} rows, need {max_rows}")
        data = data[:max_rows]
    return data


def append_uncor_file(path: str, llrs: np.ndarray) -> None:
    """Append frames of p1/p0 LLRs [num, N*z]; stored negated with 3 zero
    metadata columns, '%.1f' formatting."""
    llrs = np.asarray(llrs, dtype=np.float32).reshape(llrs.shape[0], -1)
    rows = np.concatenate([np.zeros((llrs.shape[0], 3), np.float32), -llrs], axis=1)
    with open(path, "a") as f:
        np.savetxt(f, rows, fmt="%.1f", delimiter="\t")

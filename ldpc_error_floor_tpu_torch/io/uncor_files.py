"""Uncorrected-word dataset I/O (port of
`ldpc_error_floor_tpu/io/uncor_files.py`).

Tab-separated text, one row per harvested frame: 3 metadata columns (zeros
on write, dropped on read), then the N*z *negated* channel LLRs, written
'%.1f' (negating on read restores the p1/p0 convention).

`read_uncor_file` and `append_uncor_file` go through the native codec
(`native/uncor_codec.cpp`, built with g++ at first use).  The NumPy
functions `read_uncor_file_plain` and `append_uncor_file_plain` are the
reference the codec is held to, byte for byte (`tests/test_torch_native_codec.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ldpc_error_floor_tpu_torch import native


def _take_rows(path: str, data: np.ndarray, max_rows: Optional[int]) -> np.ndarray:
    if max_rows is not None:
        if data.shape[0] < max_rows:
            raise ValueError(
                f"{path}: has {data.shape[0]} rows, need {max_rows}")
        data = data[:max_rows]
    return data


def read_uncor_file(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """Read harvested LLRs; returns [num_frames, N*z] float32 in p1/p0 LLRs."""
    return _take_rows(path, native.parse_table(path, skip_cols=3, scale=-1.0),
                      max_rows)


def append_uncor_file(path: str, llrs: np.ndarray) -> None:
    """Append frames of p1/p0 LLRs [num, N*z]; stored negated with 3 zero
    metadata columns, '%.1f' formatting."""
    llrs = np.asarray(llrs, dtype=np.float32).reshape(llrs.shape[0], -1)
    native.write_table(path, llrs, meta_cols=3, scale=-1.0, append=True)


def read_uncor_file_plain(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """`read_uncor_file` in NumPy (the codec's reference)."""
    data = np.loadtxt(path, dtype=np.float32, delimiter="\t")
    if data.ndim == 1:
        data = data[None, :]
    data = -data[:, 3:]  # drop metadata columns; stored negated
    return _take_rows(path, data, max_rows)


def append_uncor_file_plain(path: str, llrs: np.ndarray) -> None:
    """`append_uncor_file` in NumPy (the codec's reference)."""
    llrs = np.asarray(llrs, dtype=np.float32).reshape(llrs.shape[0], -1)
    rows = np.concatenate([np.zeros((llrs.shape[0], 3), np.float32), -llrs], axis=1)
    with open(path, "a") as f:
        np.savetxt(f, rows, fmt="%.1f", delimiter="\t")

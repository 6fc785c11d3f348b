"""The host's native Uncor codec (port of `ldpc_error_floor_tpu/native/`):
`uncor_codec.cpp`, built with g++ at first use and loaded with ctypes.

The library is built into the checkout's ``build/native/`` (a per-user
cache directory for an installed copy), named by a hash of the source and
the flags, so an edited source builds anew.  Each build writes a file of
its own and renames it into place, so processes that build at once do not
collide.  There is no fallback: a failed build raises with g++'s message,
and `io/uncor_files.py` always goes through the codec (its NumPy functions
stay as the reference the tests hold the codec to).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "uncor_codec.cpp"
_ROOT = Path(__file__).resolve().parents[2]
_BUILD_DIR = (_ROOT / "build" / "native"
              if (_ROOT / "pyproject.toml").is_file()
              else Path.home() / ".cache" / "ldpc_error_floor_tpu_torch")
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_FLOATS = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build `uncor_codec.cpp` (once per hash of it and the flags) into
    `_BUILD_DIR` and load it."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"uncor_codec_{digest}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building "
                               f"{_SRC}:\n{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.uncor_count.restype = ctypes.c_long
    lib.uncor_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
    lib.uncor_parse.restype = ctypes.c_long
    lib.uncor_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                _FLOATS, ctypes.c_long, ctypes.c_float]
    lib.uncor_write.restype = ctypes.c_int
    lib.uncor_write.argtypes = [ctypes.c_char_p, _FLOATS, ctypes.c_long,
                                ctypes.c_long, ctypes.c_long, ctypes.c_float,
                                ctypes.c_int]
    return lib


def parse_table(path: str, skip_cols: int, scale: float) -> np.ndarray:
    """A tab-separated float table as [rows, cols - skip_cols] float32: the
    first `skip_cols` columns dropped, the others times `scale`.  A file
    without rows gives a [0, 0] array; a row whose column count differs from
    the first's, or a field that is no number, raises ValueError."""
    lib = load_library()
    cols = ctypes.c_long(0)
    rows = lib.uncor_count(os.fsencode(path), ctypes.byref(cols))
    if rows < 0:
        raise OSError(f"{path}: cannot read")
    if rows == 0:
        return np.zeros((0, 0), np.float32)
    if cols.value <= skip_cols:
        raise ValueError(f"{path}: {cols.value} columns, at most {skip_cols} "
                         "to skip")
    out = np.empty((rows, cols.value - skip_cols), np.float32)
    got = lib.uncor_parse(os.fsencode(path), skip_cols, cols.value,
                          out.ctypes.data_as(_FLOATS), rows, ctypes.c_float(scale))
    if got == -1:
        raise OSError(f"{path}: cannot read")
    if got != rows:
        raise ValueError(f"{path}: malformed row (each row must hold "
                         f"{cols.value} numbers)")
    return out


def write_table(path: str, data: np.ndarray, meta_cols: int, scale: float,
                append: bool) -> None:
    """Write rows of `meta_cols` zero columns and the values of `data`
    times `scale`, '%.1f', tab-separated (np.savetxt's bytes)."""
    arr = np.ascontiguousarray(data, np.float32)
    if arr.ndim != 2:
        raise ValueError(f"data must be [rows, cols], got shape {arr.shape}")
    rc = load_library().uncor_write(os.fsencode(path), arr.ctypes.data_as(_FLOATS),
                                    arr.shape[0], arr.shape[1], meta_cols,
                                    ctypes.c_float(scale), int(append))
    if rc != 0:
        raise OSError(f"{path}: cannot write")

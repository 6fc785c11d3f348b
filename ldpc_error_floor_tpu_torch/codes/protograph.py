"""Protograph (base-graph) loading and code parameters.

Capability parity with the reference's code loader (`Main_Functions.py:8-38`
`init_parameter`) but built around an explicit `Code` dataclass instead of a
tuple soup, and index arrays instead of dense connectivity matrices.

Proto-matrix file format (same as the reference `BaseGraph/*.txt`):
tab-separated M x N integers; entry -1 = no edge, entry s >= 0 = circulant
shift s (taken mod z at lift time, reference `Main_Functions.py:64,72`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "codes")


def load_proto_matrix(path_or_name: str) -> np.ndarray:
    """Load a proto matrix from a .txt (tab-separated ints) or bundled .json.

    `path_or_name` may be a filesystem path or the bare name of a bundled
    code (see `ldpc_error_floor_tpu_torch/data/codes/`).
    """
    path = path_or_name
    if not os.path.exists(path):
        for cand in (
            os.path.join(_DATA_DIR, path_or_name + ".json"),
            os.path.join(_DATA_DIR, path_or_name),
        ):
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"proto matrix not found: {path_or_name!r}")
    if path.endswith(".json"):
        with open(path) as f:
            obj = json.load(f)
        proto = np.full((obj["M"], obj["N"]), -1, dtype=np.int64)
        for i, j, s in obj["edges"]:
            proto[i, j] = s
        return proto
    return np.loadtxt(path, dtype=np.int64, delimiter="\t")


def save_proto_json(proto: np.ndarray, path: str, meta: Optional[dict] = None) -> None:
    """Store a proto matrix in the compact JSON form `load_proto_matrix`
    reads: ``{"M", "N", "edges": [[i, j, shift], ...]}`` (column-major),
    with `meta` under "meta" when given."""
    m, n = proto.shape
    edges = [[int(i), int(j), int(proto[i, j])] for j in range(n) for i in range(m)
             if proto[i, j] != -1]
    obj = {"M": int(m), "N": int(n), "edges": edges}
    if meta:
        obj["meta"] = meta
    with open(path, "w") as f:
        json.dump(obj, f)


@dataclass(frozen=True)
class Code:
    """A QC-LDPC (or z=1 generic LDPC) code definition.

    Parameters mirror the reference's `init_parameter` outputs
    (`Main_Functions.py:8-38`): proto dims, degrees, edge count, effective
    n/k/rate under puncturing+shortening.  Puncture/shorten ranges are
    1-indexed inclusive bit ranges into the n_full = N*z codeword, 0 = off
    (reference `main_Base.py:31-34`).
    """

    name: str
    proto: np.ndarray  # [M, N] int64, -1 = no edge
    z: int
    punct: Tuple[int, int] = (0, 0)
    short: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        object.__setattr__(self, "proto", np.asarray(self.proto, dtype=np.int64))
        if self.proto.ndim != 2:
            raise ValueError("proto matrix must be 2-D")

    # --- proto-level structure -------------------------------------------------
    @property
    def M(self) -> int:
        return int(self.proto.shape[0])

    @property
    def N(self) -> int:
        return int(self.proto.shape[1])

    @property
    def base(self) -> np.ndarray:
        """0/1 adjacency of the proto matrix."""
        return (self.proto >= 0).astype(np.int64)

    @property
    def cn_degrees(self) -> np.ndarray:
        return self.base.sum(axis=1)

    @property
    def vn_degrees(self) -> np.ndarray:
        return self.base.sum(axis=0)

    @property
    def n_edges(self) -> int:
        return int(self.base.sum())

    # --- lifted-code parameters ------------------------------------------------
    @property
    def n_full(self) -> int:
        """Stored/decoded codeword length N*z (before puncture/shorten)."""
        return self.N * self.z

    @property
    def punct_num(self) -> int:
        ps, pe = self.punct
        return pe - ps + 1 if ps > 0 else 0

    @property
    def short_num(self) -> int:
        ss, se = self.short
        return se - ss + 1 if ss > 0 else 0

    @property
    def n(self) -> int:
        """Transmitted code length."""
        return self.n_full - self.punct_num - self.short_num

    @property
    def k(self) -> int:
        return (self.N - self.M) * self.z - self.short_num

    @property
    def rate(self) -> float:
        return self.k / self.n

    def snr_sigmas(self, snrs_db: Sequence[float]) -> np.ndarray:
        """AWGN noise std per Eb/N0 SNR point: sigma = sqrt(1/(2*10^(SNR/10)*R)).

        Matches reference `Main_Functions.py:34-36`.
        """
        snrs = np.asarray(snrs_db, dtype=np.float64)
        return np.sqrt(1.0 / (2.0 * (10.0 ** (snrs / 10.0)) * self.rate))

    @classmethod
    def load(cls, name_or_path: str, z: int, punct=(0, 0), short=(0, 0),
             name: Optional[str] = None) -> "Code":
        proto = load_proto_matrix(name_or_path)
        if name is None:
            name = os.path.splitext(os.path.basename(name_or_path))[0]
        return cls(name=name, proto=proto, z=z, punct=punct, short=short)

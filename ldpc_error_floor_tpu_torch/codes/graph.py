"""Tanner-graph index maps (a JAX-free copy of
`ldpc_error_floor_tpu/codes/graph.py`; the tables must stay identical).

The reference encodes the lifted Tanner graph as dense matmul operators
(`Main_Functions.py:46-150`): two one-hot [E*z, E*z] circulant-lift matrices
plus [E, E] extrinsic selectors, so every decoding iteration is a chain of
dense matmuls with O((E*z)^2) cost/memory.  This module replaces all of that
with static integer gather maps over node-major, degree-padded message
arrays:

* V->C messages live as ``v2c[N, Dv, z, B]`` — for each proto variable node
  ``j``, its ``Dv`` (max VN degree) padded edge slots, the lift dimension
  ``z``, and the Monte-Carlo batch ``B`` last.
* C->V messages live as ``c2v[M, Dc, z, B]`` analogously.

One decoding iteration needs exactly two row gathers on the leading
(flattened) axis — ``cn_in_idx`` routes V->C messages into check-node-major
arrangement (applying the circulant shifts), ``vn_in_idx`` routes C->V
messages back.  Padding slots gather a sentinel row that holds 0.

Lift/slot convention (equivalent to the reference's Lift_Matrix1/2,
`Main_Functions.py:56-77`): for proto edge ``e`` with shift ``s``,
check-side slot ``h`` connects to variable-side slot ``(h + s) % z``.

Edge orderings:
* VN order = column-major scan of the proto matrix (reference loops
  ``for j: for i:``, `Main_Functions.py:61-62`) — the canonical edge id here.
* CN order = row-major scan (`Main_Functions.py:69-70`) — the order in which
  per-edge CN weights are enumerated in reference weight files.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ldpc_error_floor_tpu_torch.codes.protograph import Code


@dataclass(frozen=True)
class TannerGraph:
    """Static index maps for a lifted QC-LDPC Tanner graph."""

    code: Code

    # ----- proto-level edge enumeration ---------------------------------------
    @cached_property
    def _edges(self):
        """VN-order (col-major) edge list: (cn_row i, vn_col j, shift s)."""
        proto = self.code.proto
        m, n = proto.shape
        z = self.code.z
        ii, jj, ss = [], [], []
        for j in range(n):
            for i in range(m):
                if proto[i, j] >= 0:
                    ii.append(i)
                    jj.append(j)
                    ss.append(int(proto[i, j]) % z)
        return (np.asarray(ii, np.int64), np.asarray(jj, np.int64),
                np.asarray(ss, np.int64))

    @property
    def edge_cn(self) -> np.ndarray:
        return self._edges[0]

    @property
    def edge_vn(self) -> np.ndarray:
        return self._edges[1]

    @property
    def edge_shift(self) -> np.ndarray:
        return self._edges[2]

    @property
    def E(self) -> int:
        return int(self.edge_cn.shape[0])

    @cached_property
    def cn_order_of_edge(self) -> np.ndarray:
        """CN-order (row-major) index of each VN-order edge."""
        order = np.lexsort((self.edge_vn, self.edge_cn))  # row-major sort
        inv = np.empty(self.E, dtype=np.int64)
        inv[order] = np.arange(self.E)
        return inv

    @cached_property
    def edge_of_cn_order(self) -> np.ndarray:
        """VN-order edge id for each CN-order position (inverse of above)."""
        return np.argsort(self.cn_order_of_edge)

    # ----- padded slot tables --------------------------------------------------
    @cached_property
    def Dv(self) -> int:
        return int(self.code.vn_degrees.max())

    @cached_property
    def Dc(self) -> int:
        return int(self.code.cn_degrees.max())

    @cached_property
    def vn_slots(self) -> np.ndarray:
        """[N, Dv] -> VN-order edge id, -1 = padding.  Slot order = CN-row order
        within the column (matches col-major enumeration)."""
        tab = np.full((self.code.N, self.Dv), -1, dtype=np.int64)
        fill = np.zeros(self.code.N, dtype=np.int64)
        for e in range(self.E):
            j = self.edge_vn[e]
            tab[j, fill[j]] = e
            fill[j] += 1
        return tab

    @cached_property
    def cn_slots(self) -> np.ndarray:
        """[M, Dc] -> VN-order edge id, -1 = padding.  Slot d of row i is the
        CN-order edge (cumulative row degree + d), so per-edge CN weights in
        reference weight-file order map to this table row-major."""
        tab = np.full((self.code.M, self.Dc), -1, dtype=np.int64)
        fill = np.zeros(self.code.M, dtype=np.int64)
        for e in self.edge_of_cn_order:  # row-major traversal
            i = self.edge_cn[e]
            tab[i, fill[i]] = e
            fill[i] += 1
        return tab

    @cached_property
    def _edge_to_vn_slot(self) -> np.ndarray:
        """[E] -> slot index d within vn_slots[edge_vn[e]]."""
        pos = np.empty(self.E, dtype=np.int64)
        for j in range(self.code.N):
            for d, e in enumerate(self.vn_slots[j]):
                if e >= 0:
                    pos[e] = d
        return pos

    @cached_property
    def _edge_to_cn_slot(self) -> np.ndarray:
        """[E] -> slot index d within cn_slots[edge_cn[e]]."""
        pos = np.empty(self.E, dtype=np.int64)
        for i in range(self.code.M):
            for d, e in enumerate(self.cn_slots[i]):
                if e >= 0:
                    pos[e] = d
        return pos

    # ----- lifted gather maps --------------------------------------------------
    # v2c_flat has N*Dv*z + 1 rows, row (j*Dv + d)*z + g, sentinel last.
    # c2v_flat has M*Dc*z + 1 rows, row (i*Dc + d)*z + h, sentinel last.

    @property
    def n_v2c_rows(self) -> int:
        return self.code.N * self.Dv * self.code.z

    @property
    def n_c2v_rows(self) -> int:
        return self.code.M * self.Dc * self.code.z

    @cached_property
    def cn_in_idx(self) -> np.ndarray:
        """[M*Dc*z] int32: row of v2c_flat feeding check-side slot (i, d, h)."""
        z = self.code.z
        idx = np.full((self.code.M, self.Dc, z), self.n_v2c_rows, dtype=np.int64)
        h = np.arange(z)
        for i in range(self.code.M):
            for d in range(self.Dc):
                e = self.cn_slots[i, d]
                if e < 0:
                    continue
                j = self.edge_vn[e]
                dv = self._edge_to_vn_slot[e]
                g = (h + self.edge_shift[e]) % z
                idx[i, d] = (j * self.Dv + dv) * z + g
        return idx.reshape(-1).astype(np.int32)

    @cached_property
    def vn_in_idx(self) -> np.ndarray:
        """[N*Dv*z] int32: row of c2v_flat feeding variable-side slot (j, d, g)."""
        z = self.code.z
        idx = np.full((self.code.N, self.Dv, z), self.n_c2v_rows, dtype=np.int64)
        g = np.arange(z)
        for j in range(self.code.N):
            for d in range(self.Dv):
                e = self.vn_slots[j, d]
                if e < 0:
                    continue
                i = self.edge_cn[e]
                dc = self._edge_to_cn_slot[e]
                h = (g - self.edge_shift[e]) % z
                idx[j, d] = (i * self.Dc + dc) * z + h
        return idx.reshape(-1).astype(np.int32)

    @cached_property
    def cn_vn_idx(self) -> np.ndarray:
        """[M*Dc*z] int32: row of a padded per-bit array ([N*z] + sentinel)
        holding the variable node feeding check-side slot (i, d, h).  Used for
        the UCN (unsatisfied-check) syndrome gather (reference
        `Main_Functions.py:180-209`)."""
        z = self.code.z
        idx = np.full((self.code.M, self.Dc, z), self.code.N * z, dtype=np.int64)
        h = np.arange(z)
        for i in range(self.code.M):
            for d in range(self.Dc):
                e = self.cn_slots[i, d]
                if e < 0:
                    continue
                j = self.edge_vn[e]
                g = (h + self.edge_shift[e]) % z
                idx[i, d] = j * z + g
        return idx.reshape(-1).astype(np.int32)

    # ----- weight broadcast tables --------------------------------------------
    @cached_property
    def cn_slot_edge_idx(self) -> np.ndarray:
        """[M, Dc] int32: CN-order proto-edge index of slot (i, d); padding -> 0.

        Per-edge CN/UCN weights (sharing mode 1/4) are stored in CN order, the
        order the reference enumerates them in weight files."""
        cumdeg = np.concatenate([[0], np.cumsum(self.code.cn_degrees)])
        idx = np.zeros((self.code.M, self.Dc), dtype=np.int64)
        for i in range(self.code.M):
            for d in range(self.Dc):
                if self.cn_slots[i, d] >= 0:
                    idx[i, d] = cumdeg[i] + d
        return idx.astype(np.int32)

    # ----- dense H matrix (for oracle/syndrome checks) ------------------------
    @cached_property
    def H(self) -> np.ndarray:
        """Dense binary parity-check matrix [M*z, N*z] of the lifted code."""
        z = self.code.z
        H = np.zeros((self.code.M * z, self.code.N * z), dtype=np.int8)
        for e in range(self.E):
            i, j, s = self.edge_cn[e], self.edge_vn[e], self.edge_shift[e]
            for h in range(z):
                H[i * z + h, j * z + (h + s) % z] = 1
        return H

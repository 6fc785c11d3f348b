"""Plain reference of a Monte-Carlo FER point: BPSK over AWGN, the
quantized neural min-sum decode (QMS) and the genie count.

It imports nothing of the program.  It reads the code's protograph and the
weight rows from the benchmark's frozen JSON files and works out every
table, sigma and LLR itself.  The arithmetic follows the published decoder
(arXiv:2310.07194, the upstream `Main_Functions.py`):

* LLR = 2y/sigma^2 of y = -1 + sigma*n (all-zero word, BPSK bit 0 -> -1),
  positive LLR asserting bit 1, rounded to the QMS grid (step, clip);
  punctured bits read 0, shortened bits -clip_llr;
* iteration t: the channel value times the VN weight, on the grid; a check
  is unsatisfied (UCN) under the previous iteration's decisions (t = 0: the
  weighted channel's); V->C = channel + all C->V of the bit but the edge's
  own, clipped to the grid; a zero V->C message counts as positive with
  magnitude 0; C->V = the extrinsic min of the magnitudes times the CN (or,
  on an unsatisfied check, the UCN) weight, ReLU, on the grid, with the sign
  that makes an even number of other positive inputs negative; the APP is
  the channel value plus every C->V of the bit; a bit is wrong when its APP
  is >= 0.

On the QMS grid every message and sum is a whole number of half steps, so
the reference keeps them as int16 codes and computes in float32 only where
a weight multiplies (the channel's product and the two extrinsic minima of
each check), exactly as a float32 decoder would round them.

A word's genie stop is its first iteration with no wrong bit among the
first `target` columns; it fails the genie when it has none in T
iterations.  Words that stopped leave the batch, so the work is each word's
own iterations.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

GRIDS = {6: (1.0, 15.5), 5: (0.5, 7.5), 4: (1.0, 7.0), 3: (2.0, 6.0)}  # q_bit: (step, clip)


@dataclass(frozen=True)
class RefCode:
    """A lifted QC-LDPC code from its protograph: edges (row, column, shift)
    in the file's order, lift z, and the 1-indexed inclusive punctured and
    shortened bit ranges (0, 0 = none)."""
    M: int
    N: int
    z: int
    edges: Tuple[Tuple[int, int, int], ...]
    punct: Tuple[int, int]
    short: Tuple[int, int]

    @classmethod
    def load(cls, path: str, z: int, punct: Sequence[int], short: Sequence[int]) -> "RefCode":
        with open(path) as f:
            obj = json.load(f)
        edges = tuple((int(i), int(j), int(s) % z) for i, j, s in obj["edges"] if s >= 0)
        return cls(int(obj["M"]), int(obj["N"]), z, edges, tuple(punct), tuple(short))

    @staticmethod
    def _count(rng: Sequence[int]) -> int:
        return rng[1] - rng[0] + 1 if rng[0] > 0 else 0

    @property
    def n_full(self) -> int:
        return self.N * self.z

    @property
    def rate(self) -> float:
        k = (self.N - self.M) * self.z - self._count(self.short)
        n = self.n_full - self._count(self.punct) - self._count(self.short)
        return k / n

    def sigma(self, snr_db: float) -> float:
        """Noise std at Eb/N0 `snr_db` (float64, then float32 as sampled)."""
        return float(np.float32(np.sqrt(1.0 / (2.0 * 10.0 ** (snr_db / 10.0) * self.rate))))

    def rows_of(self) -> List[List[Tuple[int, int]]]:
        """Per proto row, its (column, shift) pairs in column order."""
        rows: List[List[Tuple[int, int]]] = [[] for _ in range(self.M)]
        for i, j, s in sorted(self.edges, key=lambda e: (e[0], e[1])):
            rows[i].append((j, s))
        return rows


def load_weight_rows(path: str) -> Tuple[Tuple[int, int, int], Dict[str, Optional[np.ndarray]]]:
    """The sharing triple and per-kind [T, dim] float32 rows of a weight
    JSON file (sharing 3: one value per iteration; 2: one per proto row for
    CN/UCN, per proto column for VN)."""
    with open(path) as f:
        obj = json.load(f)
    rows = {k: None if v is None else np.asarray(v, np.float32).reshape(len(v), -1)
            for k, v in obj["blocks"].items()}
    return tuple(obj["sharing"]), rows


class _Words:
    """The decode state of a set of words, batch last: the channel LLRs
    (float32), the APP's channel codes (int8), the C->V codes of every edge
    (int8), each bit's sum of C->V codes (int16), the hard decisions (uint8)
    and which columns are live words (the others pad the set to a multiple
    of 4 words, so rows move as int32), and the next iteration."""

    FIELDS = ("llr", "app0", "c2v", "total", "bits", "live")

    def __init__(self, llr, app0, c2v, total, bits, live, t):
        self.llr, self.app0, self.c2v, self.total, self.bits, self.live, self.t = \
            llr, app0, c2v, total, bits, live, t

    @property
    def n(self) -> int:
        return self.llr.shape[1]

    def take(self, keep: torch.Tensor, live: torch.Tensor) -> "_Words":
        return _Words(*(getattr(self, k).index_select(-1, keep) for k in self.FIELDS[:-1]),
                      live, self.t)

    @staticmethod
    def cat(parts: List["_Words"]) -> "_Words":
        return _Words(*(torch.cat([getattr(p, k) for p in parts], dim=-1)
                        for k in _Words.FIELDS), parts[0].t)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of a byte tensor [rows, n], n a multiple of 4, moved as
    int32 words."""
    return a.view(torch.int32).index_select(0, idx).view(a.dtype)


class RefDecoder:
    """The QMS decoder of the module docstring on one device.

    `weights`: per kind ("cn", "ucn", "vn") [T, dim] float32 rows, None for
    an absent kind; dim 1 is shared by every row (or column), dim M (CN,
    UCN) or N (VN) is per proto node.

    Edges are grouped by check degree d and, in a group of R rows, laid out
    slot-major [d, R*z], so that each slot of every check of the group is
    one contiguous [R*z, words] slice."""

    WIDE = 1 << 18   # words decoded together: batches are joined up to this
    POOL = 1 << 11   # a set this small waits for others at its iteration

    def __init__(self, code: RefCode, weights: Dict[str, Optional[np.ndarray]], n_iters: int,
                 q_bit: int, clip_llr: float, target_node: int, device):
        self.code, self.T, self.clip_llr = code, n_iters, clip_llr
        self.step, self.clip = GRIDS[q_bit]
        self.cmax = int(round(self.clip / self.step))
        self.dev = torch.device(device)
        z = code.z
        self.target_rows = (target_node if target_node > 0 else code.N) * z
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
            self.groups.append((start, len(edge_bit), rset, d))
        self.E = len(edge_bit)
        eb = np.asarray(edge_bit)
        self.edge_bit = torch.as_tensor(eb, device=self.dev)
        self.slot_ids = torch.arange(16, dtype=torch.int8, device=self.dev)
        # bits grouped by degree: (bit ids, [bits * degree] edge ids)
        deg = np.bincount(eb, minlength=code.n_full)
        order = np.argsort(eb, kind="stable")
        starts = np.concatenate([[0], np.cumsum(deg)])
        self.vn_groups = []
        for dv in sorted(set(deg.tolist()) - {0}):
            bits = np.nonzero(deg == dv)[0]
            edges = np.concatenate([order[starts[b]:starts[b + 1]] for b in bits])
            self.vn_groups.append((torch.as_tensor(bits, device=self.dev),
                                   torch.as_tensor(edges, device=self.dev), dv))
        # CN/UCN weights per lifted check of each group: [T, R*z, 1]
        self.w = {}
        for kind in ("cn", "ucn"):
            w = weights.get(kind)
            if w is None:
                self.w[kind] = None
                continue
            if w.shape[1] not in (1, code.M):
                raise ValueError(f"{kind} weights of width {w.shape[1]}: the reference "
                                 "takes one per iteration or one per proto row")
            per_row = np.broadcast_to(w, (n_iters, code.M)) if w.shape[1] == 1 else w
            self.w[kind] = [torch.as_tensor(np.repeat(per_row[:, rset], z, axis=1),
                                            device=self.dev)[:, :, None]
                            for _, _, rset, _ in self.groups]
        w = weights.get("vn")
        if w is None:
            self.w_vn = None
        else:
            per_col = np.broadcast_to(w, (n_iters, code.N)) if w.shape[1] == 1 else w
            per_bit = np.repeat(np.ascontiguousarray(per_col), z, axis=1)  # [T, N*z]
            self.w_vn = torch.as_tensor(per_bit, device=self.dev)[:, :, None]
        bit = np.arange(1, code.n_full + 1)
        mask = lambda lo, hi: torch.as_tensor((bit >= lo) & (bit <= hi) & (lo > 0),
                                              device=self.dev)[:, None]
        self.punct, self.short = mask(*code.punct), mask(*code.short)

    # -- the channel ---------------------------------------------------------
    def llr(self, noise: torch.Tensor, sigma: float) -> torch.Tensor:
        """Float32 channel LLRs [N*z, B] of the all-zero word from N(0, 1)
        noise [N*z, B]."""
        sig = torch.full((noise.shape[1],), sigma, dtype=torch.float32, device=noise.device)
        y = -1.0 + noise * sig[None, :]
        llr = 2.0 * y / (sig[None, :] ** 2)
        llr = torch.clamp(torch.round(llr / self.step) * self.step, -self.clip, self.clip)
        llr = torch.where(self.punct, torch.zeros_like(llr), llr)
        return torch.where(self.short, torch.full_like(llr, -self.clip_llr), llr)

    def _grid_code(self, x: torch.Tensor) -> torch.Tensor:
        """Float32 values to int8 codes of the grid: round(x/step) clipped."""
        return torch.clamp(torch.round(x / self.step), -self.cmax, self.cmax).to(torch.int8)

    # -- the decode ------------------------------------------------------------
    def genie(self, llrs: Iterable[torch.Tensor]) -> Tuple[int, int]:
        """(words that fail the genie, sum of each word's own iterations to
        its genie stop, T for a failure) over batches of channel LLRs
        [N*z, B].  Batches are decoded together up to `WIDE` words; a set
        of words that has shrunk to `POOL` waits for the others that reach
        its iteration, so that few words never take a launch each."""
        fails = iters = 0
        pools: Dict[int, List[_Words]] = {}
        wide: List[torch.Tensor] = []

        def run(w: _Words) -> None:
            nonlocal fails, iters
            while True:
                iters += int(w.live.sum())
                wrong = self._iteration(w) & w.live
                if w.t == self.T:
                    fails += int(wrong.sum())
                    return
                keep = wrong.nonzero().squeeze(1)
                k = keep.numel()
                if k == 0:
                    return
                if k < w.n:
                    pad = (-k) % 4   # dead words, so the set stays a multiple of 4
                    if pad:
                        keep = torch.cat([keep, (~wrong).nonzero().squeeze(1)[:pad]])
                    live = torch.arange(k + pad, device=self.dev) < k
                    w = w.take(keep, live)
                if w.n <= self.POOL:
                    pools.setdefault(w.t, []).append(w)
                    if sum(p.n for p in pools[w.t]) >= self.WIDE // 4:
                        w = _Words.cat(pools.pop(w.t))
                        continue
                    return

        def flush_wide() -> None:
            llr = torch.cat(wide, dim=1)
            wide.clear()
            pad = (-llr.shape[1]) % 4
            n = llr.shape[1]
            if pad:
                llr = torch.cat([llr, llr[:, :1].expand(-1, pad)], dim=1)
            run(self._start(llr, torch.arange(n + pad, device=self.dev) < n))

        for llr in llrs:
            wide.append(llr)
            if sum(x.shape[1] for x in wide) >= self.WIDE:
                flush_wide()
        if wide:
            flush_wide()
        while pools:
            run(_Words.cat(pools.pop(min(pools))))
        return fails, iters

    def _start(self, llr: torch.Tensor, live: torch.Tensor) -> _Words:
        n = llr.shape[1]
        return _Words(llr, self._grid_code(llr),
                      torch.zeros((self.E, n), dtype=torch.int8, device=self.dev),
                      torch.zeros((self.code.n_full, n), dtype=torch.int16, device=self.dev),
                      None, live, 0)

    def _iteration(self, w: _Words) -> torch.Tensor:
        """Iteration w.t of the words in place; returns which are wrong."""
        t, z, n, c = w.t, self.code.z, w.n, self.cmax
        chan = self._grid_code(w.llr if self.w_vn is None else w.llr * self.w_vn[t])
        if w.bits is None:
            w.bits = (chan >= 0).to(torch.uint8)
        # V->C = channel + the bit's other C->V; |channel + all| is clipped at
        # 2c first (exact: the edge's own C->V is within c of it)
        a = torch.clamp(chan.to(torch.int16) + w.total, -2 * c, 2 * c).to(torch.int8)
        v2c = _rows(a, self.edge_bit).sub_(w.c2v).clamp_(-c, c)
        bits_e = _rows(w.bits, self.edge_bit) if self.w["ucn"] is not None else None
        new = torch.empty((self.E, n), dtype=torch.int8, device=self.dev)
        for g, (lo, hi, rset, d) in enumerate(self.groups):
            rz = len(rset) * z
            x = v2c[lo:hi].view(d, rz, n)
            out = new[lo:hi].view(d, rz, n)
            pos = x >= 0                                  # a zero message counts as positive
            mag = x.abs()
            m1, m2 = mag[0], torch.full_like(mag[0], 127)
            i1 = torch.zeros_like(mag[0])
            for k in range(1, d):
                v = mag[k]
                m2 = torch.minimum(m2, torch.maximum(m1, v))
                i1 = torch.where(v < m1, self.slot_ids[k], i1)
                m1 = torch.minimum(m1, v)
            w_t = None if self.w["cn"] is None else self.w["cn"][g][t]
            if bits_e is not None:
                unsat = (bits_e[lo:hi].view(d, rz, n).sum(dim=0, dtype=torch.uint8) & 1).bool()
                w_t = torch.where(unsat, self.w["ucn"][g][t], w_t)
            par = (pos.sum(dim=0, dtype=torch.uint8) & 1).bool()   # positive inputs, odd
            q1, q2 = self._weighted(m1, w_t), self._weighted(m2, w_t)
            a1, a2 = torch.where(par, q1, -q1), torch.where(par, q2, -q2)
            for k in range(d):
                base = torch.where(i1 == k, a2, a1)
                torch.where(pos[k], -base, base, out=out[k])
        w.c2v = new
        total = torch.empty((self.code.n_full, n), dtype=torch.int16, device=self.dev)
        for bits, edges, dv in self.vn_groups:
            total.index_copy_(0, bits, _rows(new, edges).view(-1, dv, n).sum(
                dim=1, dtype=torch.int16))
        w.total = total
        w.bits = ((w.app0.to(torch.int16) + total) >= 0).to(torch.uint8)
        w.t = t + 1
        return w.bits[: self.target_rows].amax(dim=0).bool()

    def _weighted(self, m: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
        """The grid code of ReLU(magnitude * weight) for magnitude codes m."""
        x = m.to(torch.float32) * self.step
        if w is not None:
            x = x * w
        x = torch.where(x > 0, x, torch.zeros_like(x))
        return self._grid_code(x)


def rank_seed(seed: int, rank: int, device) -> int:
    """The seed of the generator that rank `rank` of a world of more than
    one draws from, for a point whose generator was seeded with `seed`: the
    first 8 bytes, little-endian and shifted right by one, of the BLAKE2b
    digest of that generator's state bytes followed by the rank as 4
    little-endian bytes (the port's documented rule, `parallel/mesh.py`)."""
    import hashlib
    state = torch.Generator(device=device).manual_seed(seed).get_state()
    digest = hashlib.blake2b(state.numpy().tobytes() + rank.to_bytes(4, "little"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1

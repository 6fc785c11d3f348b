"""Weight store for neural min-sum decoders (port of
`ldpc_error_floor_tpu/models/weights.py`).

Sharing codes per weight kind (CN, UCN, VN):

* 0 — no weights
* 1 — per-edge, per-iteration (dim E, CN-order edge enumeration)
* 2 — per-proto-node, per-iteration (dim M for CN/UCN, N for VN)
* 3 — per-iteration scalar (dim 1)
* 4 — per-edge, temporally shared past `fixed_iter`
* 5 — per-proto-node, temporally shared past `fixed_iter`

Parameters are plain dicts ``{"cn": [rows, dim], "ucn": ..., "vn": ...}`` of
float32 tensors (``None`` for disabled kinds).  Temporal sharing stores
``fixed_iter + 1`` rows; `stack_weights` expands any mode to per-iteration
``[T, dim]`` tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.io.weight_files import (Blocks, KINDS,
                                                        bundled_weight_path,
                                                        read_weight_file,
                                                        read_weight_json)
from ldpc_error_floor_tpu_torch.utils import resolve_device

Params = Dict[str, Optional[torch.Tensor]]

_PER_ITER = (1, 2, 3)
_TEMPORAL = (4, 5)


@dataclass(frozen=True)
class WeightSpec:
    """Static description of a decoder's weight layout."""

    sharing: Tuple[int, int, int]  # (CN, UCN, VN)
    n_iters: int
    fixed_iter: int = 0
    min_w: float = 0.0
    max_w: float = 2.0

    def __post_init__(self):
        # a tuple, so that a spec hashes (a JSON config gives a list)
        object.__setattr__(self, "sharing", tuple(self.sharing))
        cn, ucn, vn = self.sharing
        for s in self.sharing:
            if s not in (0, 1, 2, 3, 4, 5):
                raise ValueError(f"bad sharing code {s}")
        if vn in (1, 4):
            raise ValueError("VN weights cannot be per-edge (sharing[2] in {1,4})")
        if ucn != 0 and ucn != cn:
            raise ValueError("UCN sharing, if nonzero, must equal CN sharing")

    @property
    def ucn_enabled(self) -> bool:
        return self.sharing[1] > 0

    def mode(self, kind: str) -> int:
        return self.sharing[KINDS.index(kind)]

    def dim(self, kind: str, graph: TannerGraph) -> int:
        m = self.mode(kind)
        if m in (1, 4):
            return graph.E
        if m in (2, 5):
            return graph.code.M if kind in ("cn", "ucn") else graph.code.N
        if m == 3:
            return 1
        return 0

    def n_rows(self, kind: str) -> int:
        m = self.mode(kind)
        if m in _PER_ITER:
            return self.n_iters
        if m in _TEMPORAL:
            return self.fixed_iter + 1
        return 0

    def iter_to_row(self, kind: str) -> np.ndarray:
        """[n_iters] -> stored row index (temporal modes reuse row fixed_iter)."""
        t = np.arange(self.n_iters)
        if self.mode(kind) in _TEMPORAL:
            return np.minimum(t, self.fixed_iter)
        return t


def init_weights(spec: WeightSpec, graph: TannerGraph,
                 init_cn: float = 1.0, init_vn: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Params:
    """Fresh parameters.  An init value of -1 draws from a normal around the
    midpoint of [min_w, max_w] with std 0.1, truncated at two std, from
    `generator` (which must live on `device`)."""
    dev = resolve_device(device)
    params: Params = {}
    for kind in KINDS:
        if spec.mode(kind) == 0:
            params[kind] = None
            continue
        shape = (spec.n_rows(kind), spec.dim(kind, graph))
        init_val = init_cn if kind in ("cn", "ucn") else init_vn
        if init_val == -1:
            if generator is None:
                raise ValueError("init value -1 draws random weights: pass a "
                                 "torch.Generator")
            mid = (spec.min_w + spec.max_w) / 2.0
            w = torch.empty(shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(w, mean=mid, std=0.1, a=mid - 0.2,
                                        b=mid + 0.2, generator=generator)
        else:
            w = torch.full(shape, float(init_val), dtype=torch.float32,
                           device=dev)
        params[kind] = w
    return params


def clip_weights(spec: WeightSpec, params: Params,
                 masks: Optional[Mapping[str, Optional[torch.Tensor]]] = None
                 ) -> Params:
    """The [min_w, max_w] box constraint, applied after every optimizer step.
    With the trainable-row `masks` (per row, [rows] as `trainable_mask`
    gives them or [rows, 1]), rows outside the mask pass through unclipped:
    frozen-prefix rows loaded from a file are never clipped."""
    out: Params = {}
    for k, v in params.items():
        if v is None:
            out[k] = None
            continue
        clipped = torch.clamp(v, spec.min_w, spec.max_w)
        if masks is not None and masks.get(k) is not None:
            m = torch.as_tensor(masks[k], device=v.device)
            if m.dim() == 1:
                m = m[:, None]
            clipped = torch.where(m > 0, clipped, v)
        out[k] = clipped
    return out


def trainable_mask(spec: WeightSpec, train_start: int, train_end: int,
                   fixed_init: int = 0) -> Dict[str, Optional[np.ndarray]]:
    """Boolean row masks selecting the current training block's variables:
    per-iteration modes train rows [max(train_start - fixed_init,
    fixed_iter), train_end); temporal modes train the single shared row."""
    lo = max(train_start - fixed_init, spec.fixed_iter)
    masks = {}
    for kind in KINDS:
        m = spec.mode(kind)
        if m == 0:
            masks[kind] = None
            continue
        rows = np.zeros(spec.n_rows(kind), bool)
        if m in _PER_ITER:
            rows[lo:train_end] = True
        else:  # temporal: only the shared pivot row
            rows[spec.fixed_iter] = True
        masks[kind] = rows
    return masks


@functools.lru_cache(maxsize=None)
def _iter_rows(spec: WeightSpec, kind: str, device: torch.device) -> torch.Tensor:
    """`spec.iter_to_row(kind)` on `device`, copied there once: a copy from
    the host waits for the card, which stalled every training step."""
    return torch.as_tensor(spec.iter_to_row(kind), device=device)


def stack_weights(spec: WeightSpec, params: Params) -> Dict[str, Optional[torch.Tensor]]:
    """Expand stored rows to per-iteration [T, dim] tensors (differentiable:
    a row shared by several iterations gathers their gradients)."""
    out = {}
    for kind in KINDS:
        v = params.get(kind)
        if v is None:
            out[kind] = None
        else:
            rows = _iter_rows(spec, kind, v.device)
            out[kind] = v.index_select(0, rows).contiguous()
    return out


def params_from_blocks(spec: WeightSpec, blocks: Blocks, graph: TannerGraph,
                       device="cuda") -> Params:
    """Build parameters from per-iteration file rows (reference text or JSON
    weight formats).  Temporal modes keep the first fixed_iter+1 rows."""
    dev = resolve_device(device)
    params: Params = {}
    for kind in KINDS:
        if spec.mode(kind) == 0:
            params[kind] = None
            continue
        rows = blocks.get(kind)
        if rows is None:
            raise ValueError(f"weight blocks missing kind {kind!r}")
        n, d = spec.n_rows(kind), spec.dim(kind, graph)
        if len(rows) < n:
            raise ValueError(f"{kind}: file has {len(rows)} rows, spec needs {n}")
        arr = np.stack([np.broadcast_to(np.atleast_1d(r), (d,)) for r in rows[:n]])
        params[kind] = torch.as_tensor(arr.astype(np.float32), device=dev)
    return params


def params_from_numpy(params: Mapping[str, Optional[np.ndarray]],
                      device="cuda") -> Params:
    """Carry parameters held as numpy arrays (e.g. the JAX package's, via
    `np.asarray`) into float32 tensors on `device`."""
    dev = resolve_device(device)
    return {k: None if params.get(k) is None else
            torch.as_tensor(np.array(params[k], np.float32), device=dev)
            for k in KINDS}


def params_to_numpy(params: Params) -> Dict[str, Optional[np.ndarray]]:
    """The reverse of `params_from_numpy`: float32 numpy copies on the host."""
    return {k: None if params.get(k) is None else
            params[k].detach().cpu().numpy().astype(np.float32)
            for k in KINDS}


def params_to_blocks(spec: WeightSpec, params: Params) -> Blocks:
    """Expand parameters to per-iteration file rows (temporal modes re-print
    the shared row)."""
    blocks: Blocks = {}
    for kind, v in params_to_numpy(params).items():
        if v is None:
            blocks[kind] = None
        else:
            rows = v[spec.iter_to_row(kind)]
            blocks[kind] = [rows[t] for t in range(spec.n_iters)]
    return blocks


def partial_update_from_blocks(spec: WeightSpec, params: Params, blocks: Blocks,
                               upto_iter: int, graph: TannerGraph) -> Params:
    """Overwrite rows for iterations [0, upto_iter) from file blocks: the
    frozen-prefix load of the block-wise schedule.  Returns new tensors."""
    out: Params = {}
    for kind in KINDS:
        v = params.get(kind)
        if v is None:
            out[kind] = None
            continue
        file_rows = blocks.get(kind)
        if file_rows is None:
            raise ValueError(f"frozen-prefix blocks missing kind {kind!r}")
        rows_np = v.detach().cpu().numpy().astype(np.float32).copy()
        d = spec.dim(kind, graph)
        for t in range(min(upto_iter, spec.n_rows(kind))):
            rows_np[t] = np.broadcast_to(np.atleast_1d(file_rows[t]), (d,))
        out[kind] = torch.as_tensor(rows_np, device=v.device)
    return out


def load_params(spec: WeightSpec, graph: TannerGraph, path_or_name: str,
                device="cuda") -> Params:
    """Load parameters from a reference text weight file or bundled JSON set,
    checking the sharing triple matches."""
    try:
        path = bundled_weight_path(path_or_name)
    except FileNotFoundError:
        path = path_or_name
    if path.endswith(".json"):
        sharing, blocks = read_weight_json(path)
    else:
        sharing, blocks = read_weight_file(path)
    if tuple(sharing) != tuple(spec.sharing):
        raise ValueError(f"{path}: sharing {sharing} != spec {spec.sharing}")
    return params_from_blocks(spec, blocks, graph, device=device)

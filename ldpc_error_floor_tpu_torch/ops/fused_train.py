"""Fused differentiable decode for training: the CUDA pair B4/B5, their
wrapper and their plain PyTorch version.

`FusedTrainKernel.apps(stacked, llr)` returns the per-iteration APP stack
``[T - t0, target*z, B]`` (iterations ``t >= DecoderConfig.app_t0``),
differentiable with respect to the stacked weights ``[T, dim]`` (the LLRs
get no gradient); `apps_and_last` also the last iteration's clipped APP
over every bit, ``[N*z, B]``, differentiable too (the JAX scan decoder's
`app_last` under ``collect='apps'``: its carry, whole under a systematic
target).  It replaces `ldpc_error_floor_tpu/ops/pallas_train.py::
FusedTrainKernel` (`apps`, `_build_vjp`):

* a tensor on the card goes to `csrc/fused_nms_train.cu` through
  `_FusedTrainFn`, a `torch.autograd.Function` whose forward launches B4
  (``fused_nms_train_fwd``: the decode, streaming the pre-clip V->C
  messages, the per-check residuals and the pre-clip APPs) and whose
  backward launches B5 (``fused_nms_train_bwd``: the reverse loop over the
  residuals, weight gradients reduced over the batch in a fixed order).
  Under a systematic target `apps_and_last` has B4 also write the last
  iteration's APP of the other rows, and B5 take their cotangent.
  For SP (neural BP) the two launches run the SP instances, B4-SP
  (``fused_nms_train_fwd_sp``) and B5-SP (``fused_nms_train_bwd_sp``);
  B4-SP streams the pre-clip V->C messages and, with UCN, the UCN mask, and
  B5-SP recomputes the tanh products from them.  A failed build or launch
  raises;
* a tensor on the CPU goes to `decode_apps_plain`: autograd through
  `ops/fused_decoder.py::plain_iterations`, whose gradient semantics are the
  JAX scan backend's (tie-splitting extrinsic min, inclusive STE and clip
  masks, ReLU subgradient 0 at 0, the additive zero nudge, UCN masks and
  signs as constants).

Under ``torch.no_grad`` (or with no weight requiring a gradient) the card
path launches B4 alone and streams only the APPs.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.models.nms import SP, DecoderConfig
from ldpc_error_floor_tpu_torch.models.weights import WeightSpec
from ldpc_error_floor_tpu_torch.ops import fused_decoder as fd

_SRC = fd._SRC.parent / "fused_nms_train.cu"
FWD, BWD = "fused_nms_train_fwd", "fused_nms_train_bwd"
FWD_SP, BWD_SP = FWD + "_sp", BWD + "_sp"  # the SP instances, B4-SP and B5-SP

Stacked = Dict[str, Optional[torch.Tensor]]


@functools.lru_cache(maxsize=None)
def load_library() -> Tuple[ctypes.CDLL, str]:
    """Build `csrc/fused_nms_train.cu` (once per source hash) into the
    decode kernel's build directory and load it.  Returns the library and
    the compiler's log (``-Xptxas -v``)."""
    lib, log = fd.build_library(_SRC)
    cfg = [ctypes.c_int] * 14 + [ctypes.c_float] * 4 + [ctypes.c_int] * 6
    lib.fused_nms_train_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 9 + cfg + [ctypes.c_void_p])
    lib.fused_nms_train_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 17 + cfg + [ctypes.c_void_p])
    lib.fused_nms_train_fwd_launch.restype = ctypes.c_int
    lib.fused_nms_train_bwd_launch.restype = ctypes.c_int
    return lib, log


def _smem_bwd(graph: TannerGraph, spec: WeightSpec, G: int, sp: bool) -> int:
    """B5's dynamic shared memory (`BwdLayout` in the .cu): the graph table,
    the mbarrier (16 bytes), one iteration's weights float [2*dim_cn +
    dim_vn] (rounded up to 16 bytes), for SP the lifted slot table int2
    [E*z], the staged residual run float [E*z + R*M*z][G] (R =
    `cres_rows`), the slot cotangents float [E*z][G]; for per-slot sums (per-edge CN
    modes 1 and 4) the per-slot CN-weight gradients float [E*z][G] and
    per-edge sums float [2][E], UCN masks uint8 [M*z][G] (with UCN); for
    per-bit sums (per-VN modes 2 and 5) the per-bit VN-weight gradients
    float [N*z][G] and per-VN sums float [N]; for the scalar and per-check
    CN modes 3, 2 and 5 one CN and one UCN sum per lifted check and word
    float [2][M*z][G]; per-warp sums float [32] (scalar VN mode 3 sums in
    registers)."""
    code = graph.code
    N, M, z, E = code.N, code.M, code.z, graph.E
    cn, vn = spec.sharing[0], spec.sharing[2]
    ucn = spec.ucn_enabled
    cn_sum = 0 if cn == 0 else ("slot" if cn in (1, 4) else "item")
    vn_sum = 0 if vn == 0 else ("bit" if vn != 3 else "regs")
    dims = 2 * spec.dim("cn", graph) + spec.dim("vn", graph)
    R = (1 if ucn else 0) if sp else (4 if ucn else 3)
    EzG, NzG, MzG = E * z * G, N * z * G, M * z * G
    return (fd._table_bytes(N, M, E) + 16 + fd._align16(4 * dims)
            + (8 * E * z if sp else 0) + 4 * (EzG + R * MzG) + 4 * EzG
            + (4 * EzG + 8 * E + (MzG if ucn else 0) if cn_sum == "slot" else 0)
            + (4 * NzG + 4 * N if vn_sum == "bit" else 0)
            + (8 * MzG if cn_sum == "item" else 0) + 4 * 32)


def train_launch_shape(graph: TannerGraph, spec: WeightSpec, backward: bool,
                       sp: bool = False) -> Tuple[int, int, int]:
    """(G words per block, threads per block, shared bytes) of B4 or B5 (of
    B4-SP or B5-SP with `sp`).  B4 lays out its shared memory as the decode
    kernel does (`ops/fused_decoder.py::_smem_bytes`, for SP with the
    lifted slot table); B5's G is also the tile width W of the residual
    streams.  B4 and B5 run two blocks per SM under the pair's launch bound
    (576 threads a block, 56 registers; `ops/fused_decoder.py::
    pick_launch_shape`); B4-SP and B5-SP in the shape
    `ops/fused_decoder.py::sp_launch_shape` picks for their memory, under
    SP's bound (768 threads, 80 registers) where every check fits one chunk
    of 16 slots (wman: B4-SP two blocks of eight words and 384 threads,
    B5-SP one of eight and 768), else under the pair's (802.11n: two blocks
    of four words and 576 threads each)."""
    code = graph.code

    def smem(g):
        if backward:
            return _smem_bwd(graph, spec, g, sp)
        return fd._smem_bytes(code.N, code.M, code.z, graph.E, g, spec.ucn_enabled,
                              sp=sp)

    if not sp:
        G, threads = fd.pick_launch_shape(graph, smem, blocks=2)
    elif graph.Dc <= fd._SP_REG_DEG:  # checks of one chunk: SP's bound
        G, threads = fd.sp_launch_shape(graph, smem, two_blocks_first=not backward)
    else:  # past one chunk: the pair's bound
        G, threads = fd.sp_launch_shape(graph, smem, fd._TWO_BLOCK_THREADS,
                                        fd._TWO_BLOCK_WARPS_PER_SM)
    return G, threads, smem(G)


class LaunchPlan(NamedTuple):
    """One `FusedTrainKernel`'s launches: B4's and B5's (G, threads, shared
    bytes), B5's G being the streams' tile width, and the quantizer's
    (step, 1/step, clip)."""
    fwd: Tuple[int, int, int]
    bwd: Tuple[int, int, int]
    grid: Tuple[float, float, float]


def _train_table(graph: TannerGraph) -> np.ndarray:
    """The decode kernel's graph table plus, in VN order, edge_cn[E] (the
    check of each edge) and edge_shift[E] (its shift mod z), which B5's
    per-edge weight sums read."""
    return np.concatenate([fd._graph_table(graph), graph.edge_cn,
                           graph.edge_shift % graph.code.z]).astype(np.int32)


# ----- plain PyTorch version -----------------------------------------------------

def decode_apps_plain(graph: TannerGraph, tables: fd.PlainTables,
                      cfg: DecoderConfig, spec: WeightSpec, stacked: Stacked,
                      llr: torch.Tensor,
                      t0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(apps [T - t0, target*z, B], app_last [N*z, B]): the clipped APPs of
    iterations t >= t0 on the target columns, and the last iteration's on
    every bit, differentiable through the plain scan body."""
    z = graph.code.z
    target = cfg.target_node if cfg.target_node > 0 else graph.code.N
    apps, app = [], None
    for t, app in enumerate(fd.plain_iterations(graph, tables, cfg, spec, stacked, llr)):
        if t >= t0:
            apps.append(app[: target * z])
    return torch.stack(apps), app


# ----- the autograd Function -----------------------------------------------------

class _FusedTrainFn(torch.autograd.Function):
    """B4 forward, B5 backward.  Inputs: the kernel wrapper, whether to
    stream the residuals (a gradient is wanted), whether to write the last
    iteration's APP of the rows past the target, the stacked cn, ucn and vn
    weights (None where a kind has none) and the LLRs.  Outputs: the clipped
    APP window and those rows, clipped (None when not asked for)."""

    @staticmethod
    def forward(ctx, kern, stream, last, w_cn, w_ucn, w_vn, llr):
        weights = (w_cn, w_ucn, w_vn)
        last_pre = (torch.empty(((kern.N - kern.target) * kern.z, llr.shape[1]),
                                dtype=torch.float32, device=llr.device)
                    if last else None)
        apps_pre, hist, cres = kern._forward(weights, llr, stream, last_pre)
        ctx.kern = kern
        ctx.set_materialize_grads(False)  # an unused output: no cotangent to read
        ctx.save_for_backward(llr, hist, cres, apps_pre, last_pre, *[
            w if w is not None else torch.empty(0) for w in weights])
        ctx.has = tuple(w is not None for w in weights)
        clip = kern.cfg.clip_llr
        return (torch.clamp(apps_pre, -clip, clip),
                None if last_pre is None else torch.clamp(last_pre, -clip, clip))

    @staticmethod
    def backward(ctx, g_apps, g_last):
        llr, hist, cres, apps_pre, last_pre, *ws = ctx.saved_tensors
        weights = tuple(w if h else None for w, h in zip(ws, ctx.has))
        g_apps = torch.zeros_like(apps_pre) if g_apps is None else g_apps.contiguous()
        grads = ctx.kern._backward(weights, llr, hist, cres, apps_pre, g_apps, last_pre,
                                   None if g_last is None else g_last.contiguous())
        return (None, None, None, *grads, None)


# ----- the wrapper ---------------------------------------------------------------------

class FusedTrainKernel:
    """The fused differentiable decode for one (graph, config, spec).

    `launches` counts the CUDA launches of this wrapper under
    ``fused_nms_train_fwd`` (B4) and ``fused_nms_train_bwd`` (B5), or, for
    SP, ``fused_nms_train_fwd_sp`` (B4-SP) and ``fused_nms_train_bwd_sp``
    (B5-SP)."""

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig, spec: WeightSpec):
        self.graph = graph
        self.cfg = cfg
        self.spec = spec
        code = graph.code
        self.N, self.M, self.z, self.E = code.N, code.M, code.z, graph.E
        self.T = spec.n_iters
        self.target = cfg.target_node if cfg.target_node > 0 else self.N
        if not 0 <= cfg.app_t0 <= self.T - 1:
            raise ValueError(f"app_t0 {cfg.app_t0} outside [0, {self.T - 1}]")
        self.t0 = cfg.app_t0
        sp = cfg.decoding_type == SP
        self.fwd_name, self.bwd_name = (FWD_SP, BWD_SP) if sp else (FWD, BWD)
        self.launches: collections.Counter = collections.Counter()
        self._plain_tables: Dict[torch.device, fd.PlainTables] = {}
        self._graph_tabs: Dict[torch.device, torch.Tensor] = {}

    def apps(self, stacked: Stacked, llr: torch.Tensor) -> torch.Tensor:
        """llr: [N*z, B] float32.  The APP stack of iterations t >= t0 on the
        target columns: the CUDA pair for a tensor on the card, the plain
        version for a tensor on the CPU."""
        if llr.device.type == "cpu":
            return self.apps_plain(stacked, llr)
        return self._pair(stacked, llr, last=False)[0]

    def apps_and_last(self, stacked: Stacked,
                      llr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the APP stack of `apps`, the last iteration's clipped APP over
        every bit [N*z, B]), both differentiable.  On the card, under a
        systematic target, B4 also writes the last APP's other rows (and B5
        takes their cotangent); at target N the last APP is ``apps[-1]``."""
        if llr.device.type == "cpu":
            return self.apps_and_last_plain(stacked, llr)
        apps, rest = self._pair(stacked, llr, last=self.target < self.N)
        return apps, apps[-1] if rest is None else torch.cat([apps[-1], rest])

    def _pair(self, stacked: Stacked, llr: torch.Tensor, last: bool):
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        if self.cfg.decoding_type == SP:
            fd.check_sp_degree(self.graph)
        ws = (stacked["cn"], stacked["ucn"], stacked["vn"])
        stream = torch.is_grad_enabled() and any(
            w is not None and w.requires_grad for w in ws)
        return _FusedTrainFn.apply(self, stream, last, *ws, llr)

    def apps_plain(self, stacked: Stacked, llr: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of `apps` on any device (the kernels'
        reference)."""
        return self.apps_and_last_plain(stacked, llr)[0]

    def apps_and_last_plain(self, stacked: Stacked,
                            llr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plain PyTorch version of `apps_and_last` on any device."""
        tabs = self._plain_tables.get(llr.device)
        if tabs is None:
            tabs = self._plain_tables[llr.device] = fd.PlainTables(
                self.graph, llr.device)
        return decode_apps_plain(self.graph, tabs, self.cfg, self.spec,
                                 stacked, llr, t0=self.t0)

    @property
    def cres_rows(self) -> int:
        """R, the check residuals B4 streams per lifted check and iteration:
        min-sum min1, min2, the negated sign product and, with UCN, the UCN
        mask (3 or 4); SP the UCN mask alone (1, or 0 without UCN)."""
        ucn = self.spec.ucn_enabled
        if self.cfg.decoding_type == SP:
            return 1 if ucn else 0
        return 4 if ucn else 3

    # ----- launches -------------------------------------------------------------

    def _weights(self, w: Optional[torch.Tensor], kind: str, device) -> int:
        return fd.check_weights(self.graph, self.spec, kind, w, device)

    def _cfg_args(self, B: int, G: int, W: int, threads: int, smem: int,
                  dim_cn: int, dim_vn: int):
        cfg, spec = self.cfg, self.spec
        qstep, qinv, qclip = self.plan.grid
        return (self.N, self.M, self.z, self.E, self.T, B, G, W, threads, smem,
                self.target, self.t0, self.graph.Dc, cfg.decoding_type,
                qstep, qinv, qclip, cfg.clip_llr, spec.sharing[0],
                int(spec.ucn_enabled), spec.sharing[2],
                int(cfg.neural_mode == "offset"), dim_cn, dim_vn)

    @functools.cached_property
    def plan(self) -> LaunchPlan:
        """The launch plan, computed at the first launch or allocation and
        kept: B4's and B5's (G, threads, shared bytes) and the quantizer's
        grid (raises for a QMS step that is not a power of two)."""
        sp = self.cfg.decoding_type == SP
        return LaunchPlan(train_launch_shape(self.graph, self.spec, False, sp),
                          train_launch_shape(self.graph, self.spec, True, sp),
                          fd.kernel_grid(self.cfg))

    @property
    def tile_width(self) -> int:
        """W, the words of one tile of the residual streams: B5's G."""
        return self.plan.bwd[0]

    def streams(self, B: int, device, stream: bool):
        """Allocate B4's outputs for B words: apps [T-t0, target*z, B] and,
        with `stream`, the residual streams in the pair's tile-major layout,
        hist [tiles, T, E*z, W] and cres [tiles, T, R*M*z, W] (None for SP
        without UCN), tiles = ceil(B / W), W = `tile_width`; the last tile's
        words past B are padding that neither kernel touches."""
        empty = functools.partial(torch.empty, dtype=torch.float32, device=device)
        apps = empty((self.T - self.t0, self.target * self.z, B))
        if not stream:
            return apps, None, None
        W = self.tile_width
        tiles = -(-B // W)
        R = self.cres_rows
        hist = empty((tiles, self.T, self.E * self.z, W))
        cres = empty((tiles, self.T, R * self.M * self.z, W)) if R else None
        return apps, hist, cres

    def _table(self, dev) -> torch.Tensor:
        tab = self._graph_tabs.get(dev)
        if tab is None:
            tab = self._graph_tabs[dev] = torch.as_tensor(
                _train_table(self.graph), device=dev)
        return tab

    def _forward(self, weights, llr: torch.Tensor, stream: bool,
                 last: Optional[torch.Tensor] = None):
        """Launch B4: (apps_pre [T-t0, target*z, B], hist or None, cres or
        None), the residual streams tile-major as `streams` allocates them
        (`cres_rows` gives R); only the pair reads them.  With `last`, a
        contiguous float32 [(N-target)*z, B] tensor (target < N), B4 also
        writes there the last iteration's pre-clip APP of the rows past the
        target."""
        Nz = self.N * self.z
        if (llr.dtype != torch.float32 or llr.dim() != 2 or llr.shape[0] != Nz
                or not llr.is_contiguous()):
            raise ValueError(f"llr must be a contiguous float32 [{Nz}, B] tensor")
        dev, B = llr.device, llr.shape[1]
        w_cn, w_ucn, w_vn = weights
        dim_cn = self._weights(w_cn, "cn", dev)
        dim_vn = self._weights(w_vn, "vn", dev)
        if self.spec.ucn_enabled:
            self._weights(w_ucn, "ucn", dev)
        rest = ((self.N - self.target) * self.z, B)
        if last is not None and (self.target == self.N or tuple(last.shape) != rest
                                 or last.dtype != torch.float32 or last.device != dev
                                 or not last.is_contiguous()):
            raise ValueError(f"last must be a contiguous float32 {list(rest)} tensor "
                             f"on {dev} (with target_node < N)")
        apps, hist, cres = self.streams(B, dev, stream)
        if B == 0:
            return apps, hist, cres
        lib, _ = load_library()
        G, threads, smem = self.plan.fwd
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            rc = lib.fused_nms_train_fwd_launch(
                ptr(llr), ptr(w_cn), ptr(w_ucn), ptr(w_vn), ptr(self._table(dev)),
                ptr(apps), ptr(hist), ptr(cres), ptr(last),
                *self._cfg_args(B, G, self.tile_width, threads, smem, dim_cn,
                                dim_vn),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_nms_train_fwd_launch failed: CUDA error {rc}")
        self.launches[self.fwd_name] += 1
        return apps, hist, cres

    def _backward(self, weights, llr, hist, cres, apps_pre, g_apps,
                  last_pre: Optional[torch.Tensor] = None,
                  g_last: Optional[torch.Tensor] = None):
        """Launch B5 on B4's outputs (hist and cres tile-major, apps_pre and
        g_apps [T-t0, target*z, B]; with `g_last`, the cotangent of the last
        APP's rows past the target, B4's `last_pre`, both [(N-target)*z,
        B]): the [T, dim] gradients of cn, ucn and vn (None for a kind
        without weights)."""
        if hist is None:
            raise RuntimeError("the forward streamed no residuals (no weight "
                               "required a gradient)")
        dev, B = llr.device, llr.shape[1]
        w_cn, w_ucn, w_vn = weights
        dim_cn = self._weights(w_cn, "cn", dev)
        dim_vn = self._weights(w_vn, "vn", dev)
        ucn = self.spec.ucn_enabled
        empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
        g_cn = empty((self.T, dim_cn)) if dim_cn else None
        g_ucn = empty((self.T, dim_cn)) if ucn else None
        g_vn = empty((self.T, dim_vn)) if dim_vn else None
        if B == 0:
            return tuple(None if g is None else g.zero_() for g in (g_cn, g_ucn, g_vn))
        G, threads, smem = self.plan.bwd
        if hist.shape[-1] != G:
            raise ValueError(f"the streams' tiles hold {hist.shape[-1]} words, "
                             f"B5 takes {G}")
        if g_last is not None and (last_pre is None or g_last.shape != last_pre.shape
                                   or not g_last.is_contiguous()):
            raise ValueError("g_last must be a contiguous tensor of last_pre's shape")
        Ez, RMz = self.E * self.z, self.cres_rows * self.M * self.z
        if Ez * G % 4 or RMz * G % 4:
            raise ValueError(f"{self.graph.code.name}: a staged residual run "
                             f"({Ez} + {RMz} rows of {G} words) is not a "
                             "multiple of 16 bytes")
        lib, _ = load_library()
        blocks = -(-B // G)
        part = lambda g: None if g is None else empty((blocks,) + tuple(g.shape))
        parts = (part(g_cn), part(g_ucn), part(g_vn))
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            rc = lib.fused_nms_train_bwd_launch(
                ptr(llr), ptr(w_cn), ptr(w_ucn), ptr(w_vn), ptr(self._table(dev)),
                ptr(hist), ptr(cres), ptr(apps_pre), ptr(g_apps),
                ptr(last_pre if g_last is not None else None), ptr(g_last),
                *[ptr(p) for p in parts], ptr(g_cn), ptr(g_ucn), ptr(g_vn),
                *self._cfg_args(B, G, G, threads, smem, dim_cn, dim_vn),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_nms_train_bwd_launch failed: CUDA error {rc}")
        self.launches[self.bwd_name] += 1
        return g_cn, g_ucn, g_vn

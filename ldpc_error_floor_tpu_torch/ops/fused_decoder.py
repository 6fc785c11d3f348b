"""Fused stats-mode NMS decode: the CUDA kernel, its wrapper and its plain
PyTorch version.

`FusedNMSKernel` replaces `ldpc_error_floor_tpu/ops/pallas_decoder.py::
FusedNMSKernel` in ``mode='stats'`` with a fixed T.  `decode_stats(stacked,
llr)` takes ``llr [N*z, B]`` float32 and per-iteration weights ``[T, dim]``
and returns ``(app_last [N*z, B] float32, err_flags [T, B] bool,
bit_errors [T, B] int32)`` against the all-zero codeword:

* a tensor on the card goes to `csrc/fused_nms_stats.cu` (built with nvcc
  at first use, bound with ctypes); a failed build or launch raises;
* a tensor on the CPU goes to `decode_stats_plain`, the port of the scan
  body of `ldpc_error_floor_tpu/models/nms.py` that the kernel is held to.

The kernel covers MS, QMS and MS_RAW.  Its SP branch is still to be ported
(ROADMAP, B1-SP); the plain version covers SP.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.models.nms import MS, QMS, SP, DecoderConfig
from ldpc_error_floor_tpu_torch.models.weights import WeightSpec
from ldpc_error_floor_tpu_torch.ops.ste import qms_grid

_PAD_MAG = 1.0e4  # magnitude sentinel excluded from extrinsic mins
_EPS_MSG = 1.0e-4  # zero-message nudge

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_nms_stats.cu"
_ROOT = Path(__file__).resolve().parents[2]
# A checkout builds into its own build/ (ignored by git); an installed copy
# into a per-user cache, since site-packages may not be writable.
_BUILD_DIR = (_ROOT / "build" / "torch_kernels"
              if (_ROOT / "pyproject.toml").is_file()
              else Path.home() / ".cache" / "ldpc_error_floor_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
               "-Xptxas", "-v")
_SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use

Stacked = Dict[str, Optional[torch.Tensor]]


# ----- build and bind ----------------------------------------------------------

def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the fused "
                           "decode kernel cannot be built")
    return nvcc


@functools.lru_cache(maxsize=None)
def load_library() -> Tuple[ctypes.CDLL, str]:
    """Build `csrc/fused_nms_stats.cu` (once per source hash) into
    `_BUILD_DIR` and load it.  Returns the library and the
    compiler's log (``-Xptxas -v``: registers, shared memory, spills)."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"fused_nms_stats_{digest}.so"
    log = ""
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib_path)
        log = res.stderr
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.fused_nms_stats_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, log


def _smem_bytes(N: int, z: int, E: int, G: int, ucn: bool) -> int:
    """Dynamic shared memory of one block of G words, as the kernel lays it
    out: C->V float [E*z][G], bit totals float [N*z][G], error counts int
    [2][G], then UCN bits uint8 [N*z][G].  The launch reserves this."""
    return (E * z + N * z) * G * 4 + 2 * G * 4 + (N * z * G if ucn else 0)


def launch_shape(graph: TannerGraph, ucn: bool) -> Tuple[int, int]:
    """(G codewords per block, threads per block): the most words whose
    state fits one block's shared memory (at most 32, a power of two), and a
    thread count that is a multiple of G and of the warp, preferring one
    that splits the check phase's M*z*G items evenly."""
    code = graph.code
    N, M, z, E = code.N, code.M, code.z, graph.E
    G = next((g for g in (32, 16, 8, 4, 2, 1)
              if _smem_bytes(N, z, E, g, ucn) <= _SMEM_LIMIT), None)
    if G is None:
        raise ValueError(f"{code.name}: one codeword's decoder state exceeds "
                         "a block's shared memory")
    items = M * z * G
    cands = [c for c in range(1024, 127, -32) if c % G == 0]
    threads = next((c for c in cands if items % c == 0), 512)
    return G, threads


def _graph_table(graph: TannerGraph) -> np.ndarray:
    """int32 vn_ptr[N+1] | cn_ptr[M+1] | cn_edge[E] | edge_vn[E] |
    edge_shift[E] (the layout the CUDA kernel reads)."""
    code = graph.code
    vn_deg = np.bincount(graph.edge_vn, minlength=code.N)
    cn_deg = np.bincount(graph.edge_cn, minlength=code.M)
    vn_ptr = np.concatenate([[0], np.cumsum(vn_deg)])
    cn_ptr = np.concatenate([[0], np.cumsum(cn_deg)])
    # VN-order edge ids are column-major, so VN j owns [vn_ptr[j], vn_ptr[j+1])
    assert np.array_equal(graph.edge_vn, np.repeat(np.arange(code.N), vn_deg))
    return np.concatenate([vn_ptr, cn_ptr, graph.edge_of_cn_order,
                           graph.edge_vn, graph.edge_shift % code.z]
                          ).astype(np.int32)


# ----- plain PyTorch version -----------------------------------------------------

class PlainTables:
    """Gather maps of the plain version on one device."""

    def __init__(self, graph: TannerGraph, device: torch.device):
        as_long = functools.partial(torch.as_tensor, dtype=torch.long,
                                    device=device)
        self.cn_in = as_long(graph.cn_in_idx)
        self.vn_in = as_long(graph.vn_in_idx)
        self.cn_vn = as_long(graph.cn_vn_idx)
        self.cn_edge_idx = as_long(graph.cn_slot_edge_idx)


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 in slot order (the kernel's order)."""
    s = x[:, 0]
    for d in range(1, x.shape[1]):
        s = s + x[:, d]
    return s


def _ext_min(amag: torch.Tensor) -> torch.Tensor:
    """Per-slot extrinsic min over axis 1 (min1/min2 form)."""
    m1 = amag.amin(dim=1, keepdim=True)
    i1 = amag.argmin(dim=1, keepdim=True)
    slot = torch.arange(amag.shape[1], device=amag.device).view(1, -1, 1, 1)
    is_first = slot == i1
    m2 = torch.where(is_first, _PAD_MAG, amag).amin(dim=1, keepdim=True)
    return torch.where(is_first, m2, m1)


def _extrinsic_prod(x: torch.Tensor) -> torch.Tensor:
    """For each slot along axis 1: product over all other slots."""
    ident = torch.ones_like(x[:, :1])
    f = torch.cat([ident, torch.cumprod(x, dim=1)[:, :-1]], dim=1)
    b = torch.cat([torch.flip(torch.cumprod(torch.flip(x, [1]), dim=1), [1])[:, 1:],
                   ident], dim=1)
    return f * b


def decode_stats_plain(graph: TannerGraph, tables: PlainTables,
                       cfg: DecoderConfig, spec: WeightSpec, stacked: Stacked,
                       llr: torch.Tensor):
    """The decode as a Python loop over T: the scan body of
    `ldpc_error_floor_tpu/models/nms.py` (steps 1-8) on gathers with a zero
    sentinel row.  Returns (app_last, err_flags, bit_errors)."""
    code = graph.code
    N, M, z, Dv, Dc = code.N, code.M, code.z, graph.Dv, graph.Dc
    B = llr.shape[-1]
    T = spec.n_iters
    qms = cfg.decoding_type == QMS
    target = cfg.target_node if cfg.target_node > 0 else N
    cn_mode, ucn_mode, vn_mode = spec.sharing
    ucn = spec.ucn_enabled
    dev = llr.device

    def quantize(x):
        step, clip = qms_grid(cfg.q_bit)
        return torch.clamp(torch.round(x / step) * step, -clip, clip)

    def cn_weight(w_t, mode):
        if mode in (1, 4):
            w = w_t[tables.cn_edge_idx]                      # [M, Dc]
        elif mode in (2, 5):
            w = w_t[:, None]                                 # [M, 1]
        else:
            w = w_t[0].reshape(1, 1)
        return w[:, :, None, None]

    llr3 = llr.reshape(N, z, B)
    llr_app = quantize(llr3) if qms else llr3
    zero_row = torch.zeros((1, B), dtype=torch.float32, device=dev)
    y = torch.zeros((N, Dv, z, B), dtype=torch.float32, device=dev)
    prev_bits = None
    err = torch.empty((T, B), dtype=torch.bool, device=dev)
    nerr = torch.empty((T, B), dtype=torch.int32, device=dev)
    for t in range(T):
        # (1) weighted (and quantized) channel input
        llr_w = llr3
        if vn_mode > 0:
            w_vn = stacked["vn"][t]
            llr_w = llr3 * (w_vn[:, None, None] if vn_mode in (2, 5) else w_vn[0])
        if qms:
            llr_w = quantize(llr_w)

        # (2) UCN detection from the previous iteration's APP
        if ucn:
            bits_src = ((llr_w.reshape(N * z, B) >= 0).float() if t == 0
                        else prev_bits)
            bits_pad = torch.cat([bits_src, zero_row], dim=0)
            pm = 1.0 - 2.0 * bits_pad[tables.cn_vn].reshape(M, Dc, z, B)
            u = (torch.prod(pm, dim=1) < 0).float()[:, None]

        # (3) VN update: extrinsic sum of C->V plus channel
        s_prev = _slot_sum(y)
        v2c = (llr_w[:, None] + s_prev[:, None]) - y
        v2c = quantize(v2c) if qms else torch.clamp(v2c, -cfg.clip_llr, cfg.clip_llr)
        if cfg.decoding_type in (MS, QMS):
            v2c = v2c + _EPS_MSG * (v2c == 0.0).float()

        # (4) route to check-node-major arrangement (circulant shifts)
        v2c_flat = torch.cat([v2c.reshape(N * Dv * z, B), zero_row], dim=0)
        xc = v2c_flat[tables.cn_in].reshape(M, Dc, z, B)

        # (5) CN update
        if cfg.decoding_type == SP:
            tt = torch.tanh(-0.5 * xc)
            tt = tt + (tt == 0.0).float()
            prod = torch.clamp(_extrinsic_prod(tt), -1.0 + 1e-7, 1.0 - 1e-7)
            out = -2.0 * torch.atanh(prod)
            mag = out.abs()
        else:
            amag = xc.abs() + _PAD_MAG * (xc == 0.0).float()
            sgn = torch.where(xc > 0.0, -1.0, 1.0)
            mag = _ext_min(amag)
            mag = torch.where(mag.abs() <= _EPS_MSG, mag - _EPS_MSG, mag)
            out = mag * (-(torch.prod(sgn, dim=1, keepdim=True) * sgn))

        # (6) neural CN/UCN weighting + ReLU + clip/quantize
        if cn_mode == 0:
            wmag = mag
        else:
            w = cn_weight(stacked["cn"][t], cn_mode)
            if ucn:
                w_u = cn_weight(stacked["ucn"][t], ucn_mode)
                w = w * (1.0 - u) + w_u * u
            wmag = mag - w if cfg.neural_mode == "offset" else mag * w
        wmag = wmag * (wmag > 0.0).float()
        wmag = quantize(wmag) if qms else torch.clamp(wmag, -cfg.clip_llr, cfg.clip_llr)
        c2v = wmag * torch.sign(out)

        # (7) route back to variable-node-major arrangement
        c2v_flat = torch.cat([c2v.reshape(M * Dc * z, B), zero_row], dim=0)
        y = c2v_flat[tables.vn_in].reshape(N, Dv, z, B)

        # (8) APP, hard decisions and stats against the all-zero word
        app = torch.clamp(llr_app + _slot_sum(y), -cfg.clip_llr, cfg.clip_llr)
        app_flat = app.reshape(N * z, B)
        prev_bits = (app_flat >= 0.0).float()
        wrong = app_flat[: target * z] >= 0.0
        nerr[t] = wrong.sum(dim=0, dtype=torch.int32)
        err[t] = wrong.any(dim=0)
    return app_flat, err, nerr


# ----- the wrapper -------------------------------------------------------------------

class FusedNMSKernel:
    """Stats-mode fused decode for one (graph, config, spec).

    `launches` counts the CUDA kernel launches made by this wrapper.
    """

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig, spec: WeightSpec):
        self.graph = graph
        self.cfg = cfg
        self.spec = spec
        code = graph.code
        self.N, self.M, self.z, self.E = code.N, code.M, code.z, graph.E
        self.T = spec.n_iters
        self.target = cfg.target_node if cfg.target_node > 0 else self.N
        self.launches = 0
        self._plain_tables: Dict[torch.device, PlainTables] = {}
        self._graph_tabs: Dict[torch.device, torch.Tensor] = {}

    def decode_stats(self, stacked: Stacked, llr: torch.Tensor):
        """llr: [N*z, B] float32.  The CUDA kernel for a tensor on the card,
        the plain version for a tensor on the CPU."""
        if llr.device.type == "cpu":
            return self.decode_stats_plain(stacked, llr)
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        return self._launch(stacked, llr)

    def decode_stats_plain(self, stacked: Stacked, llr: torch.Tensor):
        """The plain PyTorch version on any device (the kernel's reference)."""
        tabs = self._plain_tables.get(llr.device)
        if tabs is None:
            tabs = self._plain_tables[llr.device] = PlainTables(self.graph, llr.device)
        return decode_stats_plain(self.graph, tabs, self.cfg, self.spec,
                                  stacked, llr)

    def _weights(self, stacked: Stacked, kind: str, device) -> Tuple[Optional[torch.Tensor], int]:
        if self.spec.mode(kind) == 0:
            return None, 0
        w = stacked[kind]
        dim = self.spec.dim(kind, self.graph)
        if (w is None or w.dtype != torch.float32 or w.device != device
                or tuple(w.shape) != (self.T, dim) or not w.is_contiguous()):
            raise ValueError(f"{kind} weights must be a contiguous float32 "
                             f"[{self.T}, {dim}] tensor on {device}")
        return w, dim

    def _launch(self, stacked: Stacked, llr: torch.Tensor):
        cfg, spec = self.cfg, self.spec
        if cfg.decoding_type == SP:
            raise NotImplementedError("the CUDA kernel has no SP branch yet "
                                      "(ROADMAP item B1-SP)")
        Nz = self.N * self.z
        if (llr.dtype != torch.float32 or llr.dim() != 2 or llr.shape[0] != Nz
                or not llr.is_contiguous()):
            raise ValueError(f"llr must be a contiguous float32 [{Nz}, B] tensor")
        dev = llr.device
        B = llr.shape[1]
        w_cn, dim_cn = self._weights(stacked, "cn", dev)
        w_vn, dim_vn = self._weights(stacked, "vn", dev)
        w_ucn = self._weights(stacked, "ucn", dev)[0] if spec.ucn_enabled else None
        tab = self._graph_tabs.get(dev)
        if tab is None:
            tab = self._graph_tabs[dev] = torch.as_tensor(
                _graph_table(self.graph), device=dev)
        app = torch.empty((Nz, B), dtype=torch.float32, device=dev)
        err = torch.empty((self.T, B), dtype=torch.bool, device=dev)
        nerr = torch.empty((self.T, B), dtype=torch.int32, device=dev)
        if B == 0:
            return app, err, nerr
        lib, _ = load_library()
        G, threads = launch_shape(self.graph, spec.ucn_enabled)
        smem = _smem_bytes(self.N, self.z, self.E, G, spec.ucn_enabled)
        qms = cfg.decoding_type == QMS
        qstep, qclip = qms_grid(cfg.q_bit) if qms else (1.0, cfg.clip_llr)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fused_nms_stats_launch(
                ptr(llr), ptr(w_cn), ptr(w_ucn), ptr(w_vn), ptr(tab),
                ptr(app), ptr(err), ptr(nerr),
                self.N, self.M, self.z, self.E, self.T, B, G, threads, smem,
                self.target, cfg.decoding_type, qstep, qclip, cfg.clip_llr,
                spec.sharing[0], int(spec.ucn_enabled), spec.sharing[2],
                int(cfg.neural_mode == "offset"), dim_cn, dim_vn, stream)
        if rc != 0:
            raise RuntimeError(f"fused_nms_stats launch failed: CUDA error {rc}")
        self.launches += 1
        return app, err, nerr

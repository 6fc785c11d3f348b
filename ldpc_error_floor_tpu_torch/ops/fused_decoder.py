"""Fused NMS decode: the CUDA kernel, its wrapper and its plain PyTorch
versions.

`FusedNMSKernel` replaces `ldpc_error_floor_tpu/ops/pallas_decoder.py::
FusedNMSKernel` in all its modes, for every decoding type (SP, MS, QMS,
MS_RAW).  It takes ``llr [N*z, B]`` float32 and per-iteration weights
``[T, dim]`` and counts errors against the codeword bits ``labels``
(``[target*z, B]``, bit 1 where ``labels >= 0.5``; None: the all-zero
codeword), as the JAX scan decoder does (its Pallas path ignores labels):

* `decode_stats` returns ``(app_last [N*z, B] float32, err_flags [T, B]
  bool, bit_errors [T, B] int32)`` and, under ``cfg.track_syndrome``, a
  fourth, ``syndrome_ok [T, B]`` bool: a fixed T, or with
  ``DecoderConfig.early_stop`` the genie early stop: under QMS each word
  stops after its own first correct iteration (B2, the kernel's lanes take
  a new word as each one stops), for the float states a block of G words
  once each of them has decoded at least once; the rows of skipped
  iterations read 0 and the APP is that of the stop (`group`);
* `decode_deploy` returns ``(app [N*z, B], wrong [B] bool, bit_errors [B]
  int32, iters [B] int32, detected_fail [B] bool)``, each word frozen at
  its first iteration whose hard decisions satisfy H*x = 0;
* `decode_read_totals` takes a host read of K batches, ``llr [K, N*z, B]``,
  and returns the simulator's three genie counters summed over its words
  (int64 [3]): under QMS with the early stop, on the card, one launch of B2
  that writes no rows and no APP and totals them itself.

A tensor on the card goes to `csrc/fused_nms_stats.cu` (built with nvcc at
first use, bound with ctypes); a failed build or launch raises.  Labels
reach the kernel as one byte per bit (``labels >= 0.5`` on the card, no
host read) and run each mode's second instance; ``track_syndrome`` runs
the fixed T's third (labels or not); the zero word keeps its own.  Under QMS
the kernel keeps its state in integer codes (`code_grid`, three blocks per
SM, six under the syndrome stop; the early stop is a kernel of its own,
four blocks per SM, at most as many blocks as the card holds at once, that
stop each word alone); MS, MS_RAW
and SP keep float state: SP two blocks per SM (one under the early stop),
MS and MS_RAW one.  A tensor on the CPU goes to `decode_stats_plain` /
`decode_deploy_plain`, ports of the scan body of
`ldpc_error_floor_tpu/models/nms.py` that the kernel is held to.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.models.nms import MS, QMS, SP, DecoderConfig
from ldpc_error_floor_tpu_torch.models.weights import WeightSpec
from ldpc_error_floor_tpu_torch.ops.ste import clip_tf_grad, qms_grid, quantize_ste
from ldpc_error_floor_tpu_torch.utils import profiling

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
_SMEM_PER_SM = 233_472  # shared memory of one H100 SM (228 KB)
_SMEM_RESERVED = 1_024  # of it, reserved for each resident block
# threads per block of the training pair, built to run two blocks per SM
# (kTwoBlockThreads of the .cuh: at most 56 registers a thread, so an SM
# holds 36 of its warps)
_TWO_BLOCK_THREADS = 576
_TWO_BLOCK_WARPS_PER_SM = 36
# the launch bound of the code-domain decode instances (kCodeThreads,
# kCodeBlocks, kEarlyStopBlocks, kDeployThreads, kDeployBlocks of the
# .cuh): blocks of at most 384 threads, three per SM, four under the genie
# early stop; six of at most 192 under the syndrome stop
_CODE_THREADS = 384
_CODE_BLOCKS = 3
_EARLY_STOP_BLOCKS = 4
_DEPLOY_THREADS = 192
_DEPLOY_BLOCKS = 6
# the launch bound of the SP decode instances (kSPThreads): blocks of at
# most 768 threads, so at most 80 registers a thread, and an SM holds 24 of
# their warps (each of its four schedulers 16384 // (80 * 32) = 6)
_SP_THREADS = 768
_SP_WARPS_PER_SM = 24
_MAX_C2V_CODE = 63  # a C->V code is 7-bit two's complement
_LUT_INTS = 132  # kLutInts: the code state's table of output bytes
_WORD_STOP_CTL = 16  # kWordStopCtl: the early stop's control ints of a block
_MAX_TOT_CODE = 16383  # a bit total is an int16 code, doubled
_MAX_DEG_SP = 64  # kMaxDegSP of the .cu: the largest check degree SP takes
_SP_REG_DEG = 16  # kSPRegDeg: the slots of one chunk of SP's registers

# the kernel's modes, in the .cu's numbering, by the name its launches count under
FIXED, EARLY_STOP, DEPLOY = 0, 1, 2
_MODE_NAMES = ("fused_nms_stats", "fused_nms_early_stop", "fused_nms_deploy")

Stacked = Dict[str, Optional[torch.Tensor]]


def kernel_name(mode: int, sp: bool) -> str:
    """The name a launch in `mode` counts under (``_sp``: the SP branch)."""
    return _MODE_NAMES[mode] + ("_sp" if sp else "")


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


def build_library(src_path: Path) -> Tuple[ctypes.CDLL, str]:
    """Build one kernel source (once per hash of it, the headers beside it
    and the flags) into `_BUILD_DIR` and load it.  Returns the library and
    the compiler's log (``-Xptxas -v``: registers, shared memory, spills;
    kept beside the library, so a cached build returns it too)."""
    src = src_path.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(src_path.parent.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"{src_path.stem}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src_path)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        log_path.write_text(res.stderr)
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(lib_path)), log


@functools.lru_cache(maxsize=None)
def load_library() -> Tuple[ctypes.CDLL, str]:
    """Build and load `csrc/fused_nms_stats.cu` (`build_library`)."""
    lib, log = build_library(_SRC)
    fn = lib.fused_nms_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 6 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    occ = lib.fused_nms_resident_blocks
    occ.argtypes = [ctypes.c_int] * 5
    occ.restype = ctypes.c_int
    pair = lib.fused_nms_word_stop_counters
    pair.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    pair.restype = ctypes.c_int
    return lib, log


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _table_bytes(N: int, M: int, E: int) -> int:
    """Bytes of the graph table staged in shared memory (`_graph_table`),
    rounded up to 16."""
    return _align16(4 * (4 * E + N + M + 2))


def _smem_bytes(N: int, M: int, z: int, E: int, G: int, ucn: bool,
                deploy: bool = False, code: bool = False, sp: bool = False,
                track: bool = False, early_stop: bool = False,
                lut_iters: int = 0) -> int:
    """Dynamic shared memory of one block of G words, as the kernel lays it
    out: the graph table (`_table_bytes`), one iteration's weights float
    [2E + N] (cn, ucn, vn at most; rounded up to 16 bytes), then
    - the float state: for SP (`sp`) the lifted slot table int2 [E*z],
      then C->V float [E*z][G], bit totals float [N*z][G],
      error counts int [2][G], in deploy mode two more int [G] (frozen flag,
      last unsatisfied step), with `track` (the fixed T's syndrome flags)
      two more int [G], parity bits uint8 [N*z][G] (with UCN, in deploy
      mode or with `track`);
    - the code state (`code`): the counts, deploy and syndrome flags as
      above and the table of output bytes int [_LUT_INTS], padded to 16
      bytes, the lifted slot table int2 [E*z], bit totals int16 [N*z][G]
      (twice the code plus the bit's hard decision), C->V bytes [E*z][G];
    - the code state's early stop (`code` and `early_stop`: the genie stop
      per word, `word_stop_layout` of the .cuh) no weights, then int
      [2G] counts and, per lane, word, t, stopped word, phase-B flag, LLR
      flags and next word's source [G] each, and `_WORD_STOP_CTL` ints of
      the block (padded to 16 bytes), the output-byte tables uint16
      [lut_iters][_LUT_INTS] (padded to 16 bytes), the lifted slot table
      ushort2 [E*z], per lane bit totals int16 [N*z] and LLR codes int8
      [N*z], two tiles' LLR codes int8 [2][N*z][G], per lane C->V bytes
      [E*z].
    The launch reserves this (and the kernel refuses another size)."""
    if code and early_stop:
        return (_table_bytes(N, M, E) + _align16(4 * (8 * G + _WORD_STOP_CTL))
                + _align16(2 * _LUT_INTS * lut_iters) + 4 * E * z + 5 * N * z * G
                + E * z * G)
    cnt = (4 if deploy or track else 2) * G
    bits = N * z * G if ucn or deploy or track else 0
    head = _table_bytes(N, M, E) + _align16(4 * (2 * E + N))
    if code:  # no parity bits: each is bit 0 of its bit's packed total
        return (head + _align16(4 * (cnt + _LUT_INTS)) + 8 * E * z
                + 2 * N * z * G + E * z * G)
    return head + (8 * E * z if sp else 0) + (E * z + N * z) * G * 4 + cnt * 4 + bits


def _fits(smem: int, blocks: int) -> bool:
    """Whether `blocks` blocks of `smem` shared bytes fit one SM."""
    return smem <= _SMEM_LIMIT and blocks * (smem + _SMEM_RESERVED) <= _SMEM_PER_SM


def pick_launch_shape(graph: TannerGraph, smem: Callable[[int], int],
                      blocks: int = 1,
                      max_threads: Optional[int] = None) -> Tuple[int, int]:
    """(G codewords per block, threads per block) of a kernel whose block of
    G words needs ``smem(G)`` bytes of shared memory: the most words (at
    most 32, a power of two) of which `blocks` blocks fit one SM, else of
    which one block fits, and a thread count that is a multiple of G and of
    the warp, at most `max_threads` (the kernel's launch bound; by default
    1024, or `_TWO_BLOCK_THREADS` for the kernels built to run two blocks
    per SM), preferring one that splits the check phase's M*z*G items
    evenly."""
    code = graph.code
    words = (32, 16, 8, 4, 2, 1)
    G = next((g for g in words if _fits(smem(g), blocks)), None)
    G = G or next((g for g in words if smem(g) <= _SMEM_LIMIT), None)
    if G is None:
        raise ValueError(f"{code.name}: one codeword's state exceeds a "
                         "block's shared memory")
    items = code.M * code.z * G
    top = max_threads or (1024 if blocks == 1 else _TWO_BLOCK_THREADS)
    cands = [c for c in range(top, 127, -32) if c % G == 0]
    threads = next((c for c in cands if items % c == 0), min(512, top))
    return G, threads


def sp_launch_shape(graph: TannerGraph, smem: Callable[[int], int],
                    max_threads: int = _SP_THREADS,
                    warps_per_sm: int = _SP_WARPS_PER_SM,
                    two_blocks_first: bool = True) -> Tuple[int, int]:
    """(G, threads) of an SP kernel whose block of G words needs ``smem(G)``
    bytes, under a launch bound of `max_threads` threads a block and
    `warps_per_sm` resident warps (the SP decode kernel's by default, for a
    fixed T and the syndrome stop; the training pair's for B4-SP and
    B5-SP): of the shapes whose block fits (G a power of two up to 32,
    threads a multiple of G and of the warp from 64 to `max_threads`), the
    one that keeps the most threads resident on an SM, then fills the check
    phase's rounds best (M*z*G items, one per thread and round), then holds
    two blocks or more (one block's barrier leaves the SM the other's
    warps; after the words without `two_blocks_first`, as B5-SP measured),
    then has the most words, then the most blocks.  On the H100 it picks
    the fastest of every such shape (or one within 1.6% of it) on each code
    measured (`tools/torch_kernel_ab.py --kernels sp_shapes`, seven codes;
    `--kernels sp_train_shapes`, three)."""
    code = graph.code
    best = None
    for G in (32, 16, 8, 4, 2, 1):
        size = smem(G)
        if size > _SMEM_LIMIT:
            continue
        items = code.M * code.z * G
        for threads in range(64, max_threads + 1, 32):
            if threads % G:
                continue
            blocks = min(_SMEM_PER_SM // (size + _SMEM_RESERVED),
                         warps_per_sm // (threads // 32))
            if blocks == 0:
                continue
            fill = items / (-(-items // threads) * threads)
            key = ((blocks * threads, fill, blocks >= 2, G, blocks) if two_blocks_first
                   else (blocks * threads, fill, G, blocks >= 2, blocks))
            if best is None or key > best[0]:
                best = (key, G, threads)
    if best is None:
        raise ValueError(f"{code.name}: one codeword's state exceeds a "
                         "block's shared memory")
    return best[1], best[2]


def launch_shape(graph: TannerGraph, ucn: bool, deploy: bool = False,
                 code: bool = False, early_stop: bool = False,
                 sp: bool = False, track: bool = False,
                 lut_iters: int = 0) -> Tuple[int, int]:
    """(G, threads) of the decode kernel (`pick_launch_shape`): for the code
    state (`code`) `_CODE_BLOCKS` blocks of up to `_CODE_THREADS` per SM,
    `_EARLY_STOP_BLOCKS` under the genie early stop (G lanes a block,
    `lut_iters` output-byte tables staged), `_DEPLOY_BLOCKS` of up
    to `_DEPLOY_THREADS` under the syndrome stop; for SP (`sp`)
    `sp_launch_shape`, under the early stop one block of up to
    `_SP_THREADS`; for the other float states one block of up to 1024.
    `track`: the fixed T writing the syndrome flags (`_smem_bytes`)."""
    c = graph.code
    smem = lambda g: _smem_bytes(c.N, c.M, c.z, graph.E, g, ucn, deploy, code, sp,
                                 track, early_stop, lut_iters)
    if sp and not early_stop:
        return sp_launch_shape(graph, smem)
    if code and early_stop:
        # G lanes: the words a block of the loop's state held at the early
        # stop's blocks per SM (8 on wman, 2 on 5G z 64), where they fit;
        # more lanes would leave each word fewer threads, and a step waits
        # for its slowest lane
        if graph.E * c.z > 0xFFFF:
            raise ValueError(f"{c.name}: the early stop's 16-bit slot table takes "
                             f"at most 65535 edge slots, not {graph.E * c.z}")
        G, threads = pick_launch_shape(
            graph, lambda g: _smem_bytes(c.N, c.M, c.z, graph.E, g, ucn, code=True),
            _EARLY_STOP_BLOCKS, _CODE_THREADS)
        while G > 1 and not _fits(smem(G), _EARLY_STOP_BLOCKS):
            G //= 2
        return G, threads
    if code and deploy:
        blocks, top = _DEPLOY_BLOCKS, _DEPLOY_THREADS
    elif code:
        blocks, top = _EARLY_STOP_BLOCKS if early_stop else _CODE_BLOCKS, _CODE_THREADS
    else:
        blocks, top = 1, _SP_THREADS if sp else 1024
    return pick_launch_shape(graph, smem, blocks, top)


def word_stop_lut_iters(graph: TannerGraph, T: int, cn_mode: int) -> int:
    """The output-byte tables the code state's early stop stages: all T
    iterations' for no or scalar CN weights (sharing 0 or 3), where they
    keep the G and the blocks per SM of the layout without them; else 0,
    and phase B forms a check's two bytes itself."""
    if cn_mode not in (0, 3):
        return 0
    c = graph.code
    size = lambda g, n: _smem_bytes(c.N, c.M, c.z, graph.E, g, False, code=True,
                                    early_stop=True, lut_iters=n)
    G = launch_shape(graph, False, code=True, early_stop=True)[0]
    return T if _fits(size(G, T), _EARLY_STOP_BLOCKS) else 0


def _graph_table(graph: TannerGraph) -> np.ndarray:
    """The graph table the CUDA kernels stage into shared memory (int32):
    for each check-order position q, the four ints (e*z, vn*z, shift, e) of
    its VN-order edge e (one 16-byte load gives a slot's bases and its
    circulant shift, reduced mod z) | vn_ptr[N+1] | cn_ptr[M+1]."""
    code = graph.code
    z = code.z
    vn_deg = np.bincount(graph.edge_vn, minlength=code.N)
    cn_deg = np.bincount(graph.edge_cn, minlength=code.M)
    vn_ptr = np.concatenate([[0], np.cumsum(vn_deg)])
    cn_ptr = np.concatenate([[0], np.cumsum(cn_deg)])
    # VN-order edge ids are column-major, so VN j owns [vn_ptr[j], vn_ptr[j+1])
    assert np.array_equal(graph.edge_vn, np.repeat(np.arange(code.N), vn_deg))
    e = graph.edge_of_cn_order
    slots = np.stack([e * z, graph.edge_vn[e] * z, graph.edge_shift[e] % z, e],
                     axis=1)
    return np.concatenate([slots.ravel(), vn_ptr, cn_ptr]).astype(np.int32)


def kernel_grid(cfg: DecoderConfig) -> Tuple[float, float, float]:
    """(step, 1/step, clip) of the kernels' quantizer: the QMS grid, which
    must have a power-of-two step (x * (1/step) is then exactly the float
    x / step, so the kernels multiply where the plain versions divide), or
    (1, 1, clip_llr) for the other types.  Raises for another step."""
    if cfg.decoding_type != QMS:
        return 1.0, 1.0, cfg.clip_llr
    step, clip = qms_grid(cfg.q_bit)
    if not (step > 0.0 and math.frexp(step)[0] == 0.5):
        raise ValueError(f"the kernels' quantizer takes power-of-two steps; "
                         f"q_bit {cfg.q_bit} has step {step}")
    return step, 1.0 / step, clip


def code_grid(cfg: DecoderConfig, graph: TannerGraph) -> Tuple[float, float, int, int]:
    """(u, 1/u, clip/u, log2(step/u)) of the decode kernels' code-domain
    state under QMS: u is the largest power of two that divides both the
    grid's step and its clip, so every C->V message, V->C message and bit
    total is an integer number of u.  Raises when the codes do not fit:
    a C->V code is 7-bit two's complement (|code| <= 63), a bit total
    (channel value plus the messages of the graph's largest VN degree) an
    int16 beside its hard decision (|code| <= 16383)."""
    step, _, clip = kernel_grid(cfg)
    u = step
    while clip / u != math.floor(clip / u):
        u /= 2.0
    clipc, qshift = int(clip / u), int(math.log2(step / u))
    if clipc > _MAX_C2V_CODE or clipc * (graph.Dv + 1) > _MAX_TOT_CODE:
        raise ValueError(f"q_bit {cfg.q_bit} on {graph.code.name}: codes of "
                         f"{clipc} units per message do not fit the kernels' "
                         "code-domain state")
    return u, 1.0 / u, clipc, qshift


def check_sp_degree(graph: TannerGraph) -> None:
    """Raise unless the SP kernels take the graph's largest check degree
    (kMaxDegSP of csrc/fused_nms_kernel.cuh: B5-SP keeps a check's clip
    masks in 64 bits and its running products at kSPChunks chunk tops)."""
    if graph.Dc > _MAX_DEG_SP:
        raise ValueError(f"the SP kernels take check degrees up to {_MAX_DEG_SP}; "
                         f"{graph.code.name} has {graph.Dc}")


def check_weights(graph: TannerGraph, spec: WeightSpec, kind: str,
                  w: Optional[torch.Tensor], device) -> int:
    """A kernel's stacked weights of one kind: None for a kind without
    weights, else a contiguous float32 [T, dim] tensor on `device`.
    Returns dim (0 without weights); raises otherwise."""
    if spec.mode(kind) == 0:
        return 0
    T, dim = spec.n_iters, spec.dim(kind, graph)
    if (w is None or w.dtype != torch.float32 or w.device != device
            or tuple(w.shape) != (T, dim) or not w.is_contiguous()):
        raise ValueError(f"{kind} weights must be a contiguous float32 "
                         f"[{T}, {dim}] tensor on {device}")
    return dim


# ----- plain PyTorch versions ------------------------------------------------------

class PlainTables:
    """Gather maps of the plain versions on one device."""

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


def _min1_min2(amag: torch.Tensor):
    """(m1, m2, is_first) over axis 1: the min, the min over the other
    slots than the first argmin, and that slot's mask."""
    m1 = amag.amin(dim=1, keepdim=True)
    i1 = amag.argmin(dim=1, keepdim=True)
    slot = torch.arange(amag.shape[1], device=amag.device).view(
        (1, -1) + (1,) * (amag.dim() - 2))
    is_first = slot == i1
    m2 = torch.where(is_first, _PAD_MAG, amag).amin(dim=1, keepdim=True)
    return m1, m2, is_first


def ext_min_bwd(amag: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The extrinsic min's backward (port of `_ext_min_vjp_bwd` of
    `ldpc_error_floor_tpu/models/nms.py`): the reference's `tf.reduce_min`
    gradient, which splits a gradient EQUALLY AMONG TIES.  Slots tied at
    m1 receive 1/(c1-1) of each other tied slot's gradient and 1/c1 of
    every larger slot's; a unique min receives every other slot's, and the
    slots at m2 share the min slot's own."""
    m1, m2, _ = _min1_min2(amag)
    is_m1 = amag == m1
    is_m2 = amag == m2
    c1 = is_m1.sum(dim=1, keepdim=True).to(g.dtype)
    c2 = torch.clamp(is_m2.sum(dim=1, keepdim=True), min=1).to(g.dtype)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    g_above = torch.where(is_m1, zero, g).sum(dim=1, keepdim=True)
    g_min = torch.where(is_m1, g, zero).sum(dim=1, keepdim=True)
    multi = c1 > 1.0
    tied_recv = torch.where(multi, g_above / c1 + (g_min - g)
                            / torch.clamp(c1 - 1.0, min=1.0), g_above)
    m2_recv = torch.where(multi, zero, g_min / c2)
    return torch.where(is_m1, tied_recv, torch.where(is_m2, m2_recv, zero))


class _ExtMin(torch.autograd.Function):
    """Per-slot extrinsic min over axis 1 (min1/min2 form) with the
    tie-splitting backward.  Ties are the common case under QMS."""

    @staticmethod
    def forward(ctx, amag):
        m1, m2, is_first = _min1_min2(amag)
        ctx.save_for_backward(amag)
        return torch.where(is_first, m2, m1)

    @staticmethod
    def backward(ctx, g):
        (amag,) = ctx.saved_tensors
        return ext_min_bwd(amag, g)


_ext_min = _ExtMin.apply


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient: +1 at exactly 0 (torch.abs gives 0)."""
    return torch.where(x >= 0.0, x, -x)


def _clip_jnp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with its gradient: 1/2 at an exactly hit bound (max/min
    split ties, in both frameworks)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _extrinsic_prod(x: torch.Tensor) -> torch.Tensor:
    """For each slot along axis 1: product over all other slots."""
    ident = torch.ones_like(x[:, :1])
    f = torch.cat([ident, torch.cumprod(x, dim=1)[:, :-1]], dim=1)
    b = torch.cat([torch.flip(torch.cumprod(torch.flip(x, [1]), dim=1), [1])[:, 1:],
                   ident], dim=1)
    return f * b


def _parity_ok(tables: PlainTables, graph: TannerGraph,
               bits_pad: torch.Tensor) -> torch.Tensor:
    """[M, z, B] bool: lifted check satisfied by ``bits_pad [N*z + 1, B]``
    (float 0/1 decisions with a zero sentinel row)."""
    code = graph.code
    B = bits_pad.shape[-1]
    pm = 1.0 - 2.0 * bits_pad[tables.cn_vn].reshape(code.M, graph.Dc, code.z, B)
    return torch.prod(pm, dim=1) > 0


def _syndrome_ok(tables: PlainTables, graph: TannerGraph,
                 app: torch.Tensor) -> torch.Tensor:
    """[B] bool: the hard decisions of ``app [N*z, B]`` satisfy every check."""
    zero_row = app.new_zeros((1, app.shape[-1]))
    bits_pad = torch.cat([(app >= 0.0).float(), zero_row], dim=0)
    return _parity_ok(tables, graph, bits_pad).all(dim=1).all(dim=0)


def plain_iterations(graph: TannerGraph, tables: PlainTables,
                     cfg: DecoderConfig, spec: WeightSpec, stacked: Stacked,
                     llr: torch.Tensor) -> Iterator[torch.Tensor]:
    """The decode as a Python loop over T: the scan body of
    `ldpc_error_floor_tpu/models/nms.py` (steps 1-8) on gathers with a zero
    sentinel row.  Yields each iteration's clipped APP [N*z, B]."""
    code = graph.code
    N, M, z, Dv, Dc = code.N, code.M, code.z, graph.Dv, graph.Dc
    B = llr.shape[-1]
    qms = cfg.decoding_type == QMS
    cn_mode, ucn_mode, vn_mode = spec.sharing
    ucn = spec.ucn_enabled
    dev = llr.device

    def quantize(x):
        return quantize_ste(x, cfg.q_bit)

    def clip(x):
        return clip_tf_grad(x, -cfg.clip_llr, cfg.clip_llr)

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
    for t in range(spec.n_iters):
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
            u = (~_parity_ok(tables, graph, bits_pad)).float()[:, None]

        # (3) VN update: extrinsic sum of C->V plus channel
        s_prev = _slot_sum(y)
        v2c = (llr_w[:, None] + s_prev[:, None]) - y
        v2c = quantize(v2c) if qms else clip(v2c)
        if cfg.decoding_type in (MS, QMS):
            v2c = v2c + _EPS_MSG * (v2c == 0.0).float()

        # (4) route to check-node-major arrangement (circulant shifts)
        v2c_flat = torch.cat([v2c.reshape(N * Dv * z, B), zero_row], dim=0)
        xc = v2c_flat[tables.cn_in].reshape(M, Dc, z, B)

        # (5) CN update
        if cfg.decoding_type == SP:
            tt = torch.tanh(-0.5 * xc)
            tt = tt + (tt == 0.0).float()
            prod = _clip_jnp(_extrinsic_prod(tt), -1.0 + 1e-7, 1.0 - 1e-7)
            out = -2.0 * torch.atanh(prod)
            mag = _abs(out)
        else:
            amag = _abs(xc) + _PAD_MAG * (xc == 0.0).float()
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
        wmag = quantize(wmag) if qms else clip(wmag)
        c2v = wmag * torch.sign(out)

        # (7) route back to variable-node-major arrangement
        c2v_flat = torch.cat([c2v.reshape(M * Dc * z, B), zero_row], dim=0)
        y = c2v_flat[tables.vn_in].reshape(N, Dv, z, B)

        # (8) APP and hard decisions
        app = clip(llr_app + _slot_sum(y))
        app_flat = app.reshape(N * z, B)
        prev_bits = (app_flat >= 0.0).float()
        yield app_flat


def _group_any(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B] bool: whether any word of x's group (G consecutive words, the
    last group ragged) is set."""
    B = x.shape[0]
    pad = (-B) % group
    xp = torch.cat([x, x.new_zeros(pad)]) if pad else x
    return xp.view(-1, group).any(dim=1).repeat_interleave(group)[:B]


def _label_bits(labels: Optional[torch.Tensor], rows: int,
                llr: torch.Tensor) -> Optional[torch.Tensor]:
    """The codeword bits ``labels >= 0.5`` ([rows, B] bool, contiguous, on
    llr's device: one byte per bit, as the kernel reads them), or None for
    the all-zero word."""
    if labels is None:
        return None
    want = (rows, llr.shape[-1])
    if tuple(labels.shape) != want:
        raise ValueError(f"labels of shape {tuple(labels.shape)}, wanted {want}")
    if labels.device != llr.device:
        raise ValueError(f"labels on {labels.device}, llr on {llr.device}")
    return (labels >= 0.5).contiguous()


def decode_stats_plain(graph: TannerGraph, tables: PlainTables,
                       cfg: DecoderConfig, spec: WeightSpec, stacked: Stacked,
                       llr: torch.Tensor, early_stop: bool = False,
                       group: int = 1, labels: Optional[torch.Tensor] = None):
    """Stats against the codeword bits `labels` ([target*z, B], bit 1 where
    ``labels >= 0.5``; None: the all-zero word): (app_last, err_flags
    [T, B], bit_errors [T, B]), and under ``cfg.track_syndrome`` a fourth,
    syndrome_ok [T, B] (H*x == 0 at each iteration).  `early_stop` emulates
    the kernel's genie stop per `group` of consecutive words: a group stops
    after the first iteration by which each of its words has decoded at
    least once; its later rows read 0 and its APP is that of its stop
    iteration."""
    z = graph.code.z
    target = cfg.target_node if cfg.target_node > 0 else graph.code.N
    T, B, dev = spec.n_iters, llr.shape[-1], llr.device
    bits = _label_bits(labels, target * z, llr)
    err = torch.zeros((T, B), dtype=torch.bool, device=dev)
    nerr = torch.zeros((T, B), dtype=torch.int32, device=dev)
    synd = (torch.zeros((T, B), dtype=torch.bool, device=dev)
            if cfg.track_syndrome else None)
    app_out = None
    running = torch.ones(B, dtype=torch.bool, device=dev)
    still_wrong = torch.ones(B, dtype=torch.bool, device=dev)
    for t, app in enumerate(plain_iterations(graph, tables, cfg, spec,
                                             stacked, llr)):
        wrong = app[: target * z] >= 0.0
        if bits is not None:
            wrong = wrong != bits
        nerr_t = wrong.sum(dim=0, dtype=torch.int32)
        err_t = wrong.any(dim=0)
        if synd is not None:
            synd[t] = _syndrome_ok(tables, graph, app)
        if not early_stop:
            err[t], nerr[t], app_out = err_t, nerr_t, app
            continue
        err[t] = err_t & running
        nerr[t] = torch.where(running, nerr_t, 0)
        app_out = app if app_out is None else torch.where(running, app, app_out)
        still_wrong &= err_t
        running &= _group_any(still_wrong, group)
        if not running.any():
            break
    return (app_out, err, nerr) if synd is None else (app_out, err, nerr, synd)


def decode_deploy_plain(graph: TannerGraph, tables: PlainTables,
                        cfg: DecoderConfig, spec: WeightSpec, stacked: Stacked,
                        llr: torch.Tensor, labels: Optional[torch.Tensor] = None):
    """Syndrome stop (the scan twin at `ldpc_error_floor_tpu/models/nms.py`
    `collect='deploy'`), freezing in the loop: (app, wrong, bit_errors,
    iters, detected_fail), each word's frozen at its first iteration whose
    hard decisions satisfy every check (else at T-1, with detected_fail);
    errors against `labels` as in `decode_stats_plain`."""
    z = graph.code.z
    target = cfg.target_node if cfg.target_node > 0 else graph.code.N
    B, dev = llr.shape[-1], llr.device
    bits = _label_bits(labels, target * z, llr)
    run = torch.ones(B, dtype=torch.bool, device=dev)
    wrong = torch.zeros(B, dtype=torch.bool, device=dev)
    nerr = torch.zeros(B, dtype=torch.int32, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    app_out = None
    for app in plain_iterations(graph, tables, cfg, spec, stacked, llr):
        w = app[: target * z] >= 0.0
        if bits is not None:
            w = w != bits
        app_out = app if app_out is None else torch.where(run, app, app_out)
        wrong = torch.where(run, w.any(dim=0), wrong)
        nerr = torch.where(run, w.sum(dim=0, dtype=torch.int32), nerr)
        iters += run.int()
        run &= ~_syndrome_ok(tables, graph, app)
        if not run.any():
            break
    return app_out, wrong, nerr, iters, run


# ----- the early stop's engagement pair -------------------------------------------

_ENGAGED: set = set()  # the cards whose early stop counted under a profiler


def word_stop_counters(reset: bool = False) -> Dict[str, int]:
    """The code state's early-stop engagement pair, summed over the cards
    that launched it under a profiler: ``lane_steps`` (each block's lanes
    times its loop entries, idle lanes included) and ``words`` (the words
    it decoded); `reset` sets the pairs back to 0.  Synchronises with those
    cards."""
    out = {"lane_steps": 0, "words": 0}
    if not _ENGAGED:
        return out
    lib, _ = load_library()
    pair = (ctypes.c_longlong * 2)()
    for index in sorted(_ENGAGED):
        with torch.cuda.device(index):
            torch.cuda.synchronize()
            rc = lib.fused_nms_word_stop_counters(pair, int(reset))
        if rc != 0:
            raise RuntimeError(f"fused_nms_word_stop_counters failed: CUDA error {rc}")
        out["lane_steps"] += pair[0]
        out["words"] += pair[1]
    return out


def _engage(dev: torch.device) -> None:
    """Record that the early stop counts on `dev`, and let
    `utils.profiling.snapshot()` read the pair (under the early stop's
    kernel name)."""
    _ENGAGED.add(torch.cuda.current_device() if dev.index is None else dev.index)
    profiling.add_counter(kernel_name(EARLY_STOP, False), word_stop_counters,
                          lambda: word_stop_counters(reset=True))


# ----- the wrapper -------------------------------------------------------------------

class FusedNMSKernel:
    """The fused decode for one (graph, config, spec).

    `launches` counts the CUDA kernel launches made by this wrapper, by
    kernel name (`kernel_name`).  A launch made while the current stream is
    captured into a CUDA graph runs only when the graph is replayed: it
    counts in `captured`, and the graph's owner adds it to `launches` at
    each replay (`sim/fer.py`).  Under QMS the kernel keeps its state in
    codes (`code_grid`).
    """

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig, spec: WeightSpec):
        self.graph = graph
        self.cfg = cfg
        self.spec = spec
        code = graph.code
        self.N, self.M, self.z, self.E = code.N, code.M, code.z, graph.E
        self.T = spec.n_iters
        self.target = cfg.target_node if cfg.target_node > 0 else self.N
        self.launches: collections.Counter = collections.Counter()
        self.captured: collections.Counter = collections.Counter()
        self._plain_tables: Dict[torch.device, PlainTables] = {}
        self._graph_tabs: Dict[torch.device, torch.Tensor] = {}
        self.code = cfg.decoding_type == QMS  # the code-domain state

    def _lut_iters(self, mode: int) -> int:
        """The output-byte tables the code state's early stop stages
        (`word_stop_lut_iters`); 0 for every other kernel."""
        if not (self.code and mode == EARLY_STOP):
            return 0
        return word_stop_lut_iters(self.graph, self.T, self.spec.sharing[0])

    def launch_shape(self, mode: int) -> Tuple[int, int, int]:
        """(G, threads, shared bytes per block) of the kernel in `mode` (at
        a fixed T under ``cfg.track_syndrome``, with the syndrome flags;
        under the code state's early stop G is the lanes of a block)."""
        deploy, es = mode == DEPLOY, mode == EARLY_STOP
        sp = self.cfg.decoding_type == SP
        track = mode == FIXED and self.cfg.track_syndrome
        lut = self._lut_iters(mode)
        G, threads = launch_shape(self.graph, self.spec.ucn_enabled, deploy, self.code,
                                  es, sp, track, lut)
        return G, threads, _smem_bytes(self.N, self.M, self.z, self.E, G,
                                       self.spec.ucn_enabled, deploy, self.code, sp,
                                       track, es, lut)

    @property
    def group(self) -> int:
        """The granularity of the genie early stop (``cfg.early_stop``): 1
        under QMS, whose early-stop kernel stops each word at its own first
        correct iteration; for the float states G, the words of one block of
        the early-stop kernel, which stop together (without the early stop,
        the fixed-T kernel's G)."""
        if self.cfg.early_stop and self.code:
            return 1
        return self.launch_shape(EARLY_STOP if self.cfg.early_stop else FIXED)[0]

    def resident_blocks(self, mode: int) -> int:
        """Blocks of the kernel in `mode` that one SM of the current card
        holds at its launch shape (a query of the CUDA runtime)."""
        lib, _ = load_library()
        _, threads, smem = self.launch_shape(mode)
        return lib.fused_nms_resident_blocks(mode, int(self.cfg.decoding_type == SP),
                                             int(self.code), threads, smem)

    def decode_stats(self, stacked: Stacked, llr: torch.Tensor,
                     labels: Optional[torch.Tensor] = None, app: bool = True):
        """llr: [N*z, B] float32.  The CUDA kernel (fixed T, or the genie
        early stop under ``cfg.early_stop``) for a tensor on the card, the
        plain version for a tensor on the CPU.  `labels` and the fourth
        output under ``cfg.track_syndrome`` as in `decode_stats_plain`.
        Under the early stop the rows after a stop read 0 and the APP is
        that of the stop, so the last row's counts (FER_last, BER_last of
        `evaluate` and of a boosted decode) count each word at its stop:
        under QMS its own first correct iteration (`group` 1), for the
        float states its block's.  `app` False: the first output is None (on
        the card the code state's early stop then writes no APP; a caller
        that only counts, as the simulator, needs none)."""
        if llr.device.type == "cpu":
            out = self.decode_stats_plain(stacked, llr, labels=labels)
            return out if app else (None, *out[1:])
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        return self._launch(stacked, llr,
                            EARLY_STOP if self.cfg.early_stop else FIXED, labels, app)

    def decode_read_totals(self, stacked: Stacked, llr_read: torch.Tensor) -> torch.Tensor:
        """llr_read: [K, N*z, B] float32, the K batches of one host read
        (the all-zero word).  Returns int64 [3] on its device: bit errors
        and frames wrong at the last iteration, frames wrong at every
        iteration, summed over its K*B words (`read_totals_of_rows`).  Under
        the code state's genie early stop on the card, one launch of B2 over
        the K*B words that writes no rows and no APP: a word that ends at T
        still wrong adds its bit errors and itself (a word that was ever
        correct has stopped, so its last row is 0, and both frame counts
        are these words).  Otherwise, and on the CPU, `read_totals_of_rows`."""
        self._check_read(llr_read)
        if llr_read.device.type == "cuda" and self.code and self.cfg.early_stop:
            return self._launch(stacked, llr_read, EARLY_STOP, read=True)
        return self.read_totals_of_rows(stacked, llr_read)

    def read_totals_of_rows(self, stacked: Stacked, llr_read: torch.Tensor,
                            plain: bool = False) -> torch.Tensor:
        """The totals of `decode_read_totals` from rows, on any device: each
        batch of the read decoded alone (`decode_stats`, or with `plain`
        `decode_stats_plain`), its rows reduced to [bit errors of the last
        row, frames wrong there, frames wrong at every row] and summed."""
        self._check_read(llr_read)
        acc = None
        for llr in llr_read:
            _, err, nerr = (self.decode_stats_plain(stacked, llr) if plain
                            else self.decode_stats(stacked, llr, app=False))[:3]
            counts = torch.stack([nerr[-1].sum(dtype=torch.int64),
                                  err[-1].sum(dtype=torch.int64),
                                  err.all(dim=0).sum(dtype=torch.int64)])
            acc = counts if acc is None else acc + counts
        return acc

    def _check_read(self, llr_read: torch.Tensor) -> None:
        Nz = self.N * self.z
        if llr_read.dim() != 3 or llr_read.shape[1] != Nz:
            raise ValueError(f"a read's llr must be [K, {Nz}, B], not "
                             f"{tuple(llr_read.shape)}")

    def decode_deploy(self, stacked: Stacked, llr: torch.Tensor,
                      labels: Optional[torch.Tensor] = None):
        """llr: [N*z, B] float32.  The syndrome-stop kernel for a tensor on
        the card, the plain version for a tensor on the CPU; `labels` as in
        `decode_stats`."""
        if llr.device.type == "cpu":
            return self.decode_deploy_plain(stacked, llr, labels=labels)
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        return self._launch(stacked, llr, DEPLOY, labels)

    def _tables(self, device) -> PlainTables:
        tabs = self._plain_tables.get(device)
        if tabs is None:
            tabs = self._plain_tables[device] = PlainTables(self.graph, device)
        return tabs

    def decode_stats_plain(self, stacked: Stacked, llr: torch.Tensor,
                           early_stop: Optional[bool] = None,
                           group: Optional[int] = None,
                           labels: Optional[torch.Tensor] = None):
        """The plain PyTorch version on any device (the kernel's reference).
        `early_stop` defaults to the config's, `group` to the kernel's G."""
        if early_stop is None:
            early_stop = self.cfg.early_stop
        return decode_stats_plain(self.graph, self._tables(llr.device),
                                  self.cfg, self.spec, stacked, llr,
                                  early_stop=early_stop,
                                  group=self.group if group is None else group,
                                  labels=labels)

    def decode_deploy_plain(self, stacked: Stacked, llr: torch.Tensor,
                            labels: Optional[torch.Tensor] = None):
        """The plain PyTorch version of `decode_deploy` on any device."""
        return decode_deploy_plain(self.graph, self._tables(llr.device),
                                   self.cfg, self.spec, stacked, llr, labels=labels)

    def graph_table(self, device) -> torch.Tensor:
        """The kernel's graph table (`_graph_table`) on `device`, copied
        there once."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        tab = self._graph_tabs.get(device)
        if tab is None:
            tab = self._graph_tabs[device] = torch.as_tensor(
                _graph_table(self.graph), device=device)
        return tab

    def _weights(self, stacked: Stacked, kind: str, device) -> Tuple[Optional[torch.Tensor], int]:
        w = stacked[kind] if self.spec.mode(kind) else None
        return w, check_weights(self.graph, self.spec, kind, w, device)

    def _launch(self, stacked: Stacked, llr: torch.Tensor, mode: int,
                labels: Optional[torch.Tensor] = None, want_app: bool = True,
                read: bool = False):
        """One launch in `mode`; `read`: B2 over a host read [K, N*z, B],
        returning its int64 totals (`decode_read_totals`)."""
        cfg, spec = self.cfg, self.spec
        sp = cfg.decoding_type == SP
        if sp:
            check_sp_degree(self.graph)
        Nz = self.N * self.z
        if (llr.dtype != torch.float32 or llr.dim() != 2 + read or llr.shape[-2] != Nz
                or not llr.is_contiguous()):
            raise ValueError(f"llr must be a contiguous float32 "
                             f"[{'K, ' * read}{Nz}, B] tensor")
        dev = llr.device
        B = llr.shape[-1]
        words = llr.shape[0] * B if read else B
        bits = _label_bits(labels, self.target * self.z, llr)
        w_cn, dim_cn = self._weights(stacked, "cn", dev)
        w_vn, dim_vn = self._weights(stacked, "vn", dev)
        w_ucn = self._weights(stacked, "ucn", dev)[0] if spec.ucn_enabled else None
        tab = self.graph_table(dev)
        deploy = mode == DEPLOY
        rows = () if deploy else (self.T,)
        # the code state's early stop writes no APP that is not wanted, and
        # over a read no rows either: its totals
        skip_app = not want_app and self.code and mode == EARLY_STOP
        totals = app = err = nerr = None
        if read:
            totals = torch.zeros(3, dtype=torch.int64, device=dev)
            outs = totals
        else:
            if not skip_app:
                app = torch.empty((Nz, B), dtype=torch.float32, device=dev)
            err = torch.empty(rows + (B,), dtype=torch.bool, device=dev)
            nerr = torch.empty(rows + (B,), dtype=torch.int32, device=dev)
            outs = (app, err, nerr)
        if deploy:
            outs += (torch.empty(B, dtype=torch.int32, device=dev),
                     torch.empty(B, dtype=torch.bool, device=dev))
        synd = None
        if mode == FIXED and cfg.track_syndrome:
            synd = torch.empty((self.T, B), dtype=torch.bool, device=dev)
            outs += (synd,)
        if B == 0:
            return outs
        qstep, qinv, qclip = kernel_grid(cfg)
        u, uinv, clipc, qshift = (code_grid(cfg, self.graph) if self.code
                                  else (1.0, 1.0, 0, 0))
        lib, _ = load_library()
        G, threads, smem = self.launch_shape(mode)
        ptr = lambda x: None if x is None else x.data_ptr()
        iters, fail = outs[3:] if deploy else (None, None)
        # the code state's early stop counts its lane-steps under a profiler
        engage = self.code and mode == EARLY_STOP and profiling.active()
        if engage:
            _engage(dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fused_nms_launch(
                ptr(llr), ptr(w_cn), ptr(w_ucn), ptr(w_vn), ptr(tab),
                ptr(app), ptr(err), ptr(nerr), ptr(iters), ptr(fail), ptr(bits),
                ptr(synd), self.N, self.M, self.z, self.E, self.T, B, G, threads, smem,
                self.target, cfg.decoding_type, qstep, qinv, qclip, cfg.clip_llr,
                u, uinv, clipc, qshift,
                spec.sharing[0], int(spec.ucn_enabled), spec.sharing[2],
                int(cfg.neural_mode == "offset"), dim_cn, dim_vn, mode,
                int(sp), int(self.code), int(self._lut_iters(mode) > 0), int(engage),
                words, ptr(totals), stream)
        if rc != 0:
            raise RuntimeError(f"fused_nms_launch ({kernel_name(mode, sp)}) "
                               f"failed: CUDA error {rc}")
        if torch.cuda.is_current_stream_capturing():
            self.captured[kernel_name(mode, sp)] += 1
        else:
            self.launches[kernel_name(mode, sp)] += 1
        return outs if want_app or read else (None, *outs[1:])

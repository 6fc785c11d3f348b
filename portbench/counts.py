"""The benchmark's frozen yardstick: operations and bytes per kernel, the
card's peaks, and the summary of a `torch.profiler` Chrome trace.

Copied from the port's `chip_smoke.py` (`bound`, `sampler_bound`,
`train_bound`, `trace_summary`) so that a change to the program cannot move
the yardstick.  The counts take plain shapes (`Shape`) and not the
program's objects.  One change from the copy: the early-stop decode counts
each word's own iterations to its genie stop (`word_iters`), the work its
inputs need, and never the iterations a block of words ran.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_SIMPLE_OPS_PER_S = 33.5e12  # 67 TFLOP/s f32 counts an FMA as 2; adds,
#                                 compares and selects issue at half that
SFU_OPS_PER_S = 132 * 16 * 1.98e9  # 132 SMs x 16 special-function results
#                                    per clock (compute capability 9.0) x boost clock


@dataclass(frozen=True)
class Shape:
    """What the counts read of a code and a weight set: proto edges E, proto
    rows M and columns N, lift z, iterations T, whether UCN weights are on,
    and the weights' width per kind (cn, ucn, vn; 0 without)."""
    E: int
    M: int
    N: int
    z: int
    T: int
    ucn: bool
    w_dims: Tuple[int, int, int]


def _bound(nbytes: float, ops: float, transcendentals: float = 0.0) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(ops / F32_SIMPLE_OPS_PER_S, transcendentals / SFU_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def decode_bound(s: Shape, B: int, word_iters: Optional[float] = None,
                 out_bytes_per_word: Optional[int] = None,
                 syndrome: bool = False) -> dict:
    """Least time for one min-sum decode of B words: device bytes (LLR in,
    APP out, the statistics, weights, each once) over 3.35 TB/s, and the
    algorithm's operations over the simple f32 rate.  `word_iters`: the
    (word, iteration) pairs these inputs need (B*T for a fixed T; under the
    genie early stop the sum of each word's own iterations).  Simple f32
    operations per iteration and word: 16 per edge slot (VN sum, extrinsic
    subtract, clamp, zero nudge, abs, min1/min2 update, sign and its
    product, extrinsic select, sign attach) plus 1 for the UCN parity, 16
    per lifted check (eps fix, weight, ReLU, quantize of min1 and min2), 10
    per bit (weight and quantize the channel value, total, APP add and
    clip, decision, count); the syndrome stop adds its parity test, 1 per
    edge slot and 1 per check."""
    Ez, Mz, Nz = s.E * s.z, s.M * s.z, s.N * s.z
    word_iters = B * s.T if word_iters is None else word_iters
    if out_bytes_per_word is None:
        out_bytes_per_word = s.T * (1 + 4)
    w_bytes = 4 * s.T * sum(s.w_dims)
    nbytes = 4 * Nz * B * 2 + B * out_bytes_per_word + w_bytes
    parity = 1 if syndrome else 0
    per_edge = 16 + (1 if s.ucn else 0) + parity
    per_check = 16 + parity
    ops = word_iters * (per_edge * Ez + per_check * Mz + 10 * Nz)
    out = _bound(nbytes, ops)
    out["word_iters"] = word_iters
    return out


def sampler_bound(R: int, B: int, quantize: bool, fold: bool = False) -> dict:
    """Least time for the channel sampler's LLR pass on R x B words: device
    bytes (the noise, the sigmas and, on the fold path, the codeword bits
    read once; the LLRs written once) over 3.35 TB/s, and its operations
    over the simple f32 rate: per word the multiply and add of y, 2y,
    sigma^2, the divide, the two blends (subtract, two multiplies, add
    each), 12; 5 more under QMS (divide, round, multiply, min, max); 5 more
    on the fold path (2b - 1, then 1 - 2b and its multiply)."""
    nbytes = 4 * R * B * (3 if fold else 2) + 4 * B
    ops = R * B * (12 + (5 if quantize else 0) + (5 if fold else 0))
    return _bound(nbytes, ops)


def train_bound(s: Shape, B: int, backward: bool, t0: int = 0, sp: bool = False) -> dict:
    """Least time for the training forward (B4) or backward (B5) on B
    words: device bytes over 3.35 TB/s against simple f32 operations over
    33.5 T/s (SP: or its tanh and atanh over the special-function units'
    rate).  A multiply that feeds an add counts once.  Bytes, each once: B4
    reads the LLRs and weights and writes the pre-clip V->C stream
    [T, E*z], the check residuals [T, R*M*z] (R: min1, min2, the negated
    sign product and, with UCN, the UCN mask for min-sum; SP the UCN mask
    alone) and the APP window [T-t0, N*z]; B5 reads the LLRs, weights,
    both streams, the pre-clip APPs and their cotangent, and writes the
    gradients.  Operations per iteration and word: B4 as the decode (16 per
    edge slot, 17 with UCN; 16 per lifted check; 10 per bit).  B5: per edge
    slot 35 (36 with UCN), per lifted check 28 (30 with UCN), per bit 8, as
    itemised in `chip_smoke.py::train_bound`; B5-SP per edge slot 45 (46
    with UCN), per lifted check 2 with UCN, per bit 4, and both SP kernels
    a tanh and an atanh per edge slot."""
    Ez, Mz, Nz = s.E * s.z, s.M * s.z, s.N * s.z
    T, ucn = s.T, s.ucn
    R = (1 if ucn else 0) if sp else (4 if ucn else 3)
    dims = sum(s.w_dims)
    stream = 4 * B * (T * Ez + T * R * Mz)
    apps = 4 * B * (T - t0) * Nz
    nbytes = 4 * Nz * B + 4 * T * dims + stream + apps
    if backward and sp:
        nbytes += apps + 4 * T * dims
        per_slot = (2 + 3) + (1 + 2) + 3 + (2 + 1 + 1) + (1 + 3 + 1 + 1 + 2) + 3 + 6 + 2 \
            + (2 + 2) + (3 + 1) + 3 + (1 if ucn else 0)
        ops = B * T * (per_slot * Ez + (2 if ucn else 0) * Mz + 4 * Nz)
    elif backward:
        nbytes += apps + 4 * T * dims
        per_slot = (5 + 2 + 3) + 2 + 2 + 1 + 3 + 1 + 5 + 4 + 4 + 3 + (1 if ucn else 0)
        per_check = 2 * (4 + 1 + 3 + 2) + 4 + 3 + 1 + (2 if ucn else 0)
        ops = B * T * (per_slot * Ez + per_check * Mz + 8 * Nz)
    else:
        ops = B * T * ((17 if ucn else 16) * Ez + 16 * Mz + 10 * Nz)
    return _bound(nbytes, ops, B * T * 2 * Ez if sp else 0.0)


def _union_ms(iv: Sequence[Tuple[float, float]]) -> float:
    busy, end = 0.0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def trace_summary(trace_path: str) -> dict:
    """From a Chrome trace of `torch.profiler`: the card's time per kernel
    name and in copies and fills (ms), its busy time (the union of its
    activities, ms), the span from its first to its last activity (ms),
    and the idle gaps between activities with what the host was doing
    around them (the innermost `user_annotation` span open at the gap's
    start)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels: Dict[str, float] = {}
    other, iv, spans = 0.0, [], []
    for e in events:
        cat, dur = e.get("cat"), e.get("dur", 0)
        if cat == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + dur / 1e3
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other += dur / 1e3
        elif cat == "user_annotation":
            spans.append((e["ts"], e["ts"] + dur, e.get("name", "")))
            continue
        else:
            continue
        iv.append((e["ts"], e["ts"] + dur))
    iv.sort()
    gaps = []
    end = None
    for a, b in iv:
        if end is not None and a > end:
            gaps.append((a - end, end))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    top_gaps = []
    for length, at in gaps[:10]:
        inside = [s for s in spans if s[0] <= at < s[1]]
        name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "outside any span"
        top_gaps.append((name, length / 1e6))
    span_ms = (iv[-1][1] - iv[0][0]) / 1e3 if iv else 0.0
    return {"kernel_ms": kernels, "copy_fill_ms": other, "device_busy_ms": _union_ms(iv),
            "device_span_ms": span_ms, "idle_gaps": top_gaps}


def kernel_ms(summary: dict, *patterns: str) -> float:
    """The card's ms in kernels whose name holds any of `patterns`."""
    return sum(ms for name, ms in summary["kernel_ms"].items()
               if any(p in name for p in patterns))


def shape_of(cfg: dict, part: str = "decoder") -> Shape:
    """The `Shape` of a configuration's decoder (or its "train" part): the
    code's sizes as its file states them, and the weights' width per kind
    (sharing 1, 4: per edge; 2, 5: per proto row, or column for VN; 3: one)."""
    c, d = cfg["code"], cfg[part]
    per_node = {"cn": c["M"], "ucn": c["M"], "vn": c["N"]}
    dims = tuple({0: 0, 1: c["E"], 2: per_node[k], 3: 1, 4: c["E"], 5: per_node[k]}[m]
                 for k, m in zip(("cn", "ucn", "vn"), d["sharing"]))
    return Shape(c["E"], c["M"], c["N"], c["z"], d["n_iters"], d["sharing"][1] > 0, dims)

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`ldpc_error_floor_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernel is built for sm_90a) and nvcc; it
builds the kernel from the repo's sources, so a fresh checkout suffices.
Phases, one JSON line each on stdout; any failed check raises and the run
exits non-zero:

1. device: `nvidia-smi` name and power limit, torch's device name;
2. build: nvcc of csrc/fused_nms_stats.cu, timed, with ptxas' register
   and shared-memory report;
3. kernel vs its plain PyTorch version on the card, same LLRs: QMS cases
   counters integer-equal and APPs bit-equal; MS counters equal and APPs
   within atol 1e-4 / rtol 1e-5.  Case (a) is the main path's
   configuration at its batch of 65536, the others use 16384;
4. end to end: `FERSimulator.run_point` on wman_N0576_R34_z24, 20 QMS
   iterations, bundled base20 weights, 4.0 dB, 2^20 frames in batches of
   65536: FER_genie in [1.5e-4, 2.7e-4], one kernel launch per batch; plain
   min-sum (all-ones weights) at least 2x worse;
5. timing with CUDA events: kernel ms per launch at B = 16384, 65536,
   262144, the plain version at B = 16384 and 65536, run_point frames/s;
6. the `kernels` line, then the card's nvidia-smi line, then the result.

It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WMAN = "wman_N0576_R34_z24"
MAIN_B = 65536
T_MAIN = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_SIMPLE_OPS_PER_S = 33.5e12  # 67 TFLOP/s f32 counts an FMA as 2; adds,
#                                  compares and selects issue at half that
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9  # 132 SMs x 128 B/clk x boost clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call on the card, CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(graph, spec, B: int) -> dict:
    """Least time for one stats decode of B words: device bytes (LLR in,
    APP out, T flags and counts, weights, each once) over 3.35 TB/s, and the
    algorithm's simple f32 operations over 33.5 T/s.  Per iteration and
    word: 16 per edge slot (VN sum, extrinsic subtract, clamp, zero nudge,
    abs, min1/min2 update, sign and its product, extrinsic select, sign
    attach) plus 1 for the UCN parity, 16 per lifted check (eps fix,
    weight, ReLU, quantize of min1 and min2), 10 per bit (weight and
    quantize the channel value, total, APP add and clip, decision, count)."""
    code = graph.code
    Ez, Mz, Nz = graph.E * code.z, code.M * code.z, code.N * code.z
    T = spec.n_iters
    w_bytes = sum(4 * T * spec.dim(k, graph) for k in ("cn", "ucn", "vn"))
    nbytes = 4 * Nz * B * 2 + T * B * (1 + 4) + w_bytes
    per_edge = 16 + (1 if spec.ucn_enabled else 0)
    ops = T * B * (per_edge * Ez + 16 * Mz + 10 * Nz)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_SIMPLE_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec, init_weights,
                                                   load_params, stack_weights)
    from ldpc_error_floor_tpu_torch.ops.fused_decoder import (FusedNMSKernel,
                                                              launch_shape,
                                                              load_library)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    _, log = load_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": bool(log), "ptxas": ptxas})

    # ---- 3. kernel vs plain on the card -----------------------------------------
    wman = get_code(WMAN)
    wman_graph = TannerGraph(wman)

    def case_weights(spec, graph, kind_of, gen):
        if kind_of == "base20":
            return stack_weights(spec, load_params(spec, graph, f"{WMAN}_base20",
                                                   device=dev))
        out = {}
        for k in ("cn", "ucn", "vn"):
            # offset mode: CN/UCN offsets in [0, 0.6], VN weights stay scales
            lo, hi = {"ones": (1.0, 1.0), "rand": (0.7, 1.3),
                      "offset": (0.0, 0.6) if k != "vn" else (0.7, 1.3)}[kind_of]
            d = spec.dim(k, graph)
            out[k] = None if d == 0 else (
                lo + (hi - lo) * torch.rand((spec.n_iters, d), generator=gen,
                                            device=dev)).contiguous()
        return out

    cases = [  # (id, code, sharing, decoding type, T, B, neural mode, weights)
        # (a) is the main path's configuration at the main path's batch
        ("a_wman_333_qms_base20", WMAN, (3, 3, 3), 2, 20, MAIN_B, "scale", "base20"),
        ("b_wman_303_qms_ones", WMAN, (3, 0, 3), 2, 20, 16384, "scale", "ones"),
        ("c_wman_110_ms_rand", WMAN, (1, 1, 0), 1, 20, 16384, "scale", "rand"),
        ("d_wman_222_qms_offset", WMAN, (2, 2, 2), 2, 5, 16384, "offset", "offset"),
        ("e_mackay_333_qms_z1", "MACKAY_N96_K48", (3, 3, 3), 2, 5, 16384, "scale", "rand"),
    ]
    max_abs_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(1234)
    for cid, cname, sharing, dec, T, B, mode, wkind in cases:
        code = wman if cname == WMAN else get_code(cname)
        graph = wman_graph if cname == WMAN else TannerGraph(code)
        spec = WeightSpec(sharing=sharing, n_iters=T)
        cfg = DecoderConfig(decoding_type=dec, neural_mode=mode)
        kern = FusedNMSKernel(graph, cfg, spec)
        stacked = case_weights(spec, graph, wkind, gen)
        snr = 3.5 if cname == WMAN else 2.0
        sig = torch.full((B,), float(code.snr_sigmas([snr])[0]), device=dev)
        llr = AWGNChannel(code, decoding_type=dec, device=dev).sample(gen, sig)
        app, err, nerr = kern.decode_stats(stacked, llr)
        app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
        torch.cuda.synchronize()
        diff = (app - app_p).abs()
        row = {"phase": "kernel_vs_plain", "case": cid, "B": B, "T": T,
               "launch_shape": list(launch_shape(graph, spec.ucn_enabled)),
               "max_abs_app_diff": diff.max().item(),
               "app_mismatches": int((app != app_p).sum()),
               "err_mismatches": int((err != err_p).sum()),
               "nerr_mismatches": int((nerr != nerr_p).sum()),
               "frames_wrong_last": int(err[-1].sum()),
               "finite": bool(torch.isfinite(app).all())}
        emit(row)
        max_abs_err = max(max_abs_err, row["max_abs_app_diff"])
        check(kern.launches == 1, f"{cid}: kernel launched {kern.launches}x")
        check(row["finite"], f"{cid}: non-finite APP")
        check(row["err_mismatches"] == 0 and row["nerr_mismatches"] == 0,
              f"{cid}: counters differ from the plain version")
        if dec == 2:
            check(row["app_mismatches"] == 0, f"{cid}: APP not bit-equal")
        else:
            check(bool(torch.allclose(app, app_p, rtol=1e-5, atol=1e-4)),
                  f"{cid}: APP outside atol 1e-4 / rtol 1e-5")

    # ---- 4. end to end: the main path -------------------------------------------
    spec = WeightSpec(sharing=(3, 3, 3), n_iters=T_MAIN)
    decoder = NMSDecoder(wman, DecoderConfig(), spec, graph=wman_graph, device=dev)
    channel = AWGNChannel(wman, device=dev)
    sim = FERSimulator(decoder, channel, batch=MAIN_B)
    params = load_params(spec, wman_graph, f"{WMAN}_base20", device=dev)
    max_frames = 2 ** 20
    decoder.kernel.launches = 0
    pt = sim.run_point(params, 4.0, torch.Generator(device=dev).manual_seed(0),
                       max_frames=max_frames, target_frame_errors=None)
    main_launches = decoder.kernel.launches
    emit({"phase": "end_to_end", "weights": "base20", **vars(pt),
          "kernel_launches": main_launches})
    check(pt.frames == max_frames, f"{pt.frames} frames, wanted {max_frames}")
    check(main_launches == max_frames // MAIN_B,
          f"{main_launches} launches for {max_frames // MAIN_B} batches")
    check(1.5e-4 <= pt.fer_genie <= 2.7e-4,
          f"base20 FER_genie {pt.fer_genie} outside [1.5e-4, 2.7e-4]")

    ones = init_weights(spec, wman_graph, device=dev)
    decoder.kernel.launches = 0
    pt_ms = sim.run_point(ones, 4.0, torch.Generator(device=dev).manual_seed(1),
                          max_frames=max_frames, target_frame_errors=None)
    emit({"phase": "end_to_end", "weights": "all-ones (plain min-sum)",
          **vars(pt_ms), "kernel_launches": decoder.kernel.launches})
    check(pt_ms.fer_genie >= 2.0 * pt.fer_genie,
          f"plain min-sum FER {pt_ms.fer_genie} not 2x base20's {pt.fer_genie}")

    # ---- 5. timing ----------------------------------------------------------------
    kern = FusedNMSKernel(wman_graph, DecoderConfig(), spec)
    stacked = stack_weights(spec, params)
    sigma = float(wman.snr_sigmas([4.0])[0])
    kernel_ms, plain_ms = {}, {}
    for B in (16384, MAIN_B, 262144):
        llr = channel.sample(gen, torch.full((B,), sigma, device=dev))
        kernel_ms[B] = time_ms(lambda: kern.decode_stats(stacked, llr),
                               reps=10 if B < 262144 else 4)
        if B <= MAIN_B:
            plain_ms[B] = time_ms(lambda: kern.decode_stats_plain(stacked, llr),
                                  reps=3, warmup=1)
    bnd = bound(wman_graph, spec, MAIN_B)
    G, threads = launch_shape(wman_graph, True)
    smem_traffic = (T_MAIN * MAIN_B * 4 * wman_graph.E * wman.z * 6)  # bytes
    emit({"phase": "timing", "card": smi, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "run_point_frames_per_sec": pt.frames_per_sec,
          "kernel_cw_per_sec": {B: B / ms * 1e3 for B, ms in kernel_ms.items()},
          "bound_at_65536": bnd, "words_per_block": G, "threads": threads,
          "smem_ms_this_design": smem_traffic / SMEM_BYTES_PER_S * 1e3})

    # ---- 6. summary -----------------------------------------------------------------
    emit({"kernels": [{
        "name": "fused_nms_stats", "route": "cuda",
        "source": "ldpc_error_floor_tpu_torch/csrc/fused_nms_stats.cu",
        "replaces": "ldpc_error_floor_tpu/ops/pallas_decoder.py:435",
        "launches": main_launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms[MAIN_B], "plain_ms": plain_ms[MAIN_B],
        "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

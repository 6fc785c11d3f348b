#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`ldpc_error_floor_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc; it
builds the kernels from the repo's sources, so a fresh checkout suffices.
Phases, one JSON line each on stdout; any failed check raises and the run
exits non-zero:

1. device: `nvidia-smi` name and power limit, torch's device name;
2. build: nvcc of csrc/fused_nms_stats.cu (every mode of the decode kernel
   in one library), timed, with ptxas' register and shared-memory report;
3. each kernel against its plain PyTorch version on the card, same LLRs:
   - fixed T (B1): QMS counters integer-equal and APPs bit-equal; MS
     counters equal and APPs within atol 1e-4 / rtol 1e-5;
   - genie early stop (B2): flags, counts and QMS APPs equal to the plain
     version grouped as the kernel groups words; the genie-failure mask
     equal to the fixed-T kernel's; base20 at T=20 and boosted30 at T=30;
   - syndrome stop (B3): wrong/bit errors/iters/detected_fail integer-equal
     and QMS APPs bit-equal; against the stats kernel: wrong and bit errors
     equal its row iters-1, genie failures within wrong, detected_fail
     implies wrong;
   - SP (B1-SP): APPs within atol 1e-3 / rtol 1e-4, counters equal on at
     least 99.9% of words (the count of words that differ is printed);
   the main path's configurations run at its batch of 65536;
4. end to end, each path driven through `FERSimulator.run_point` with the
   launch counts set to 0 just before and read just after (wman_N0576_R34_z24,
   QMS q_bit 5, sharing (3,3,3), 4.0 dB, seed 0, 2^20 frames in batches of
   65536):
   - base20, fixed T=20: FER_genie in [1.5e-4, 2.7e-4]; plain min-sum
     (all-ones weights) at least 2x worse;
   - base20 with the genie early stop: FER_genie exactly 2.0122528e-4, the
     fixed-T run's;
   - boosted30 (composed from base20 at boundary 20, T=30) with the early
     stop: genie errors at most 0.8x base20's, and identical without it;
   - base20 with the syndrome stop: FER_last >= base20's FER_genie,
     FER_undetected <= FER_last, mean iterations in [3.05, 3.35];
   - belief propagation (SP, no weights, T=20): FER_genie at most plain
     min-sum's;
5. harvest: `run_collection` with base20 and the early stop at 4.2 dB
   collects 256 words into a temporary Uncor file; the fixed-T kernel finds
   every one wrong at every iteration, boosted30 rescues at least 25%, and
   the file holds as many rows as words were returned;
6. timing with CUDA events at batch 65536 unless noted: each kernel and its
   plain version, the early stop at 4.0 and 5.0 dB against the fixed-T
   kernel on the same LLRs, SP at 16384 too, run_point frames/s;
7. the `kernels` line, then the card's nvidia-smi line, then the result.

It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WMAN = "wman_N0576_R34_z24"
MAIN_B = 65536
T_MAIN = 20
T_BOOST = 30
MAX_FRAMES = 2 ** 20
PR1_FER_GENIE = 211 / 2 ** 20  # 2.0122528e-4: base20, fixed T, seed 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_SIMPLE_OPS_PER_S = 33.5e12  # 67 TFLOP/s f32 counts an FMA as 2; adds,
#                                  compares and selects issue at half that
SFU_OPS_PER_S = 132 * 16 * 1.98e9  # 132 SMs x 16 special-function results
#                                    per clock (compute capability 9.0) x boost clock
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


def bound(graph, spec, B: int, word_iters=None, out_bytes_per_word=None,
          syndrome: bool = False, sp: bool = False) -> dict:
    """Least time for one decode of B words: device bytes (LLR in, APP
    out, the statistics, weights, each once) over 3.35 TB/s, and the
    algorithm's operations over their peak rate.  `word_iters`: the
    (word, iteration) pairs these inputs need (B*T for a fixed T).  Simple
    f32 operations per iteration and word: 16 per edge slot (VN sum,
    extrinsic subtract, clamp, zero nudge, abs, min1/min2 update, sign and
    its product, extrinsic select, sign attach; for SP the tanh argument,
    zero fix, prefix and suffix products, clip, atanh scale, abs and sign)
    plus 1 for the UCN parity, 16 per lifted check (eps fix, weight, ReLU,
    quantize of min1 and min2), 10 per bit (weight and quantize the channel
    value, total, APP add and clip, decision, count); the syndrome stop
    adds its parity test, 1 per edge slot and 1 per check.  SP also needs
    a tanh and an atanh per edge slot on the special-function units (at
    least one result each), at 16 per SM and clock."""
    code = graph.code
    Ez, Mz, Nz = graph.E * code.z, code.M * code.z, code.N * code.z
    T = spec.n_iters
    word_iters = B * T if word_iters is None else word_iters
    if out_bytes_per_word is None:
        out_bytes_per_word = T * (1 + 4)
    w_bytes = sum(4 * T * spec.dim(k, graph) for k in ("cn", "ucn", "vn"))
    nbytes = 4 * Nz * B * 2 + B * out_bytes_per_word + w_bytes
    per_edge = 16 + (1 if spec.ucn_enabled else 0) + (1 if syndrome else 0)
    per_check = 16 + (1 if syndrome else 0)
    ops = word_iters * (per_edge * Ez + per_check * Mz + 10 * Nz)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_SIMPLE_OPS_PER_S * 1e3
    out = {"bytes": nbytes, "ops": ops, "word_iters": word_iters,
           "bytes_ms": bytes_ms, "ops_ms": ops_ms}
    if sp:
        out["transcendentals"] = word_iters * 2 * Ez
        out["transcendental_ms"] = out["transcendentals"] / SFU_OPS_PER_S * 1e3
        out["operations_bound_by"] = ("f32" if ops_ms >= out["transcendental_ms"]
                                      else "transcendentals")
        ops_ms = max(ops_ms, out["transcendental_ms"])
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    return out


def early_stop_word_iters(err, G: int) -> int:
    """(word, iteration) pairs the early-stop kernel ran, from its flags
    [T, B]: a block of G words runs until the first iteration by which each
    of its words has decoded once, or T."""
    import torch
    T, B = err.shape
    still = torch.cumprod(err.to(torch.int32), dim=0).bool()   # [T, B]
    alive = still.view(T, B // G, G).any(dim=2)                # [T, blocks]
    iters = 1 + alive[:-1].sum(dim=0)
    return int(iters.sum()) * G


def deploy_word_iters(iters, G: int) -> int:
    """(word, iteration) pairs the syndrome-stop kernel ran: a block of G
    words runs until its last word's syndrome holds, or T."""
    return int(iters.view(-1, G).amax(dim=1).sum()) * G


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.io import read_uncor_file
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec,
                                                   compose_boosted_params,
                                                   init_weights, load_params,
                                                   stack_weights)
    from ldpc_error_floor_tpu_torch.ops.fused_decoder import (FusedNMSKernel,
                                                              launch_shape,
                                                              load_library)
    from ldpc_error_floor_tpu_torch.pipelines import (ExperimentConfig,
                                                      run_collection)
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

    # ---- 3. kernels vs plain on the card -------------------------------------------
    wman = get_code(WMAN)
    wman_graph = TannerGraph(wman)
    spec20 = WeightSpec(sharing=(3, 3, 3), n_iters=T_MAIN)
    base20 = load_params(spec20, wman_graph, f"{WMAN}_base20", device=dev)
    spec30 = WeightSpec(sharing=(3, 3, 3), n_iters=T_BOOST)
    boosted30 = compose_boosted_params(
        wman_graph, spec20, base20, spec30,
        load_params(spec30, wman_graph, f"{WMAN}_boosted30", device=dev))
    gen = torch.Generator(device=dev).manual_seed(1234)
    graphs = {WMAN: wman_graph}

    def graph_of(cname):
        if cname not in graphs:
            graphs[cname] = TannerGraph(get_code(cname))
        return graphs[cname]

    def case_weights(spec, graph, kind_of):
        if kind_of in ("base20", "boosted30"):
            return stack_weights(spec, base20 if kind_of == "base20" else boosted30)
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

    def case_inputs(cname, sharing, dec, T, B, mode, wkind, snr):
        graph = graph_of(cname)
        code = graph.code
        spec = WeightSpec(sharing=sharing, n_iters=T)
        stacked = case_weights(spec, graph, wkind)
        sig = torch.full((B,), float(code.snr_sigmas([snr])[0]), device=dev)
        llr = AWGNChannel(code, decoding_type=dec, device=dev).sample(gen, sig)
        return graph, spec, stacked, llr

    max_err = {}

    def app_check(cid, dec, app, app_p, kname):
        diff = float((app - app_p).abs().max()) if app.numel() else 0.0
        max_err[kname] = max(max_err.get(kname, 0.0), diff)
        check(bool(torch.isfinite(app).all()), f"{cid}: non-finite APP")
        if dec == 2:
            check(bool((app == app_p).all()), f"{cid}: APP not bit-equal")
        elif dec == 0:
            check(bool(torch.allclose(app, app_p, rtol=1e-4, atol=1e-3)),
                  f"{cid}: APP outside atol 1e-3 / rtol 1e-4")
        else:
            check(bool(torch.allclose(app, app_p, rtol=1e-5, atol=1e-4)),
                  f"{cid}: APP outside atol 1e-4 / rtol 1e-5")
        return diff

    # (id, code, sharing, decoding type, T, B, neural mode, weights, SNR);
    # the first case of each kernel is the main path's configuration at the
    # main path's batch
    b1_cases = [
        ("a_wman_333_qms_base20", WMAN, (3, 3, 3), 2, 20, MAIN_B, "scale", "base20", 3.5),
        ("b_wman_303_qms_ones", WMAN, (3, 0, 3), 2, 20, 16384, "scale", "ones", 3.5),
        ("c_wman_110_ms_rand", WMAN, (1, 1, 0), 1, 20, 16384, "scale", "rand", 3.5),
        ("d_wman_222_qms_offset", WMAN, (2, 2, 2), 2, 5, 16384, "offset", "offset", 3.5),
        ("e_mackay_333_qms_z1", "MACKAY_N96_K48", (3, 3, 3), 2, 5, 16384, "scale", "rand", 2.0),
    ]
    for cid, cname, sharing, dec, T, B, mode, wkind, snr in b1_cases:
        graph, spec, stacked, llr = case_inputs(cname, sharing, dec, T, B, mode, wkind, snr)
        kern = FusedNMSKernel(graph, DecoderConfig(decoding_type=dec, neural_mode=mode), spec)
        app, err, nerr = kern.decode_stats(stacked, llr)
        app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
        torch.cuda.synchronize()
        row = {"phase": "kernel_vs_plain", "kernel": "fused_nms_stats", "case": cid,
               "B": B, "T": T, "launch_shape": list(launch_shape(graph, spec.ucn_enabled)),
               "max_abs_app_diff": app_check(cid, dec, app, app_p, "fused_nms_stats"),
               "app_mismatches": int((app != app_p).sum()),
               "err_mismatches": int((err != err_p).sum()),
               "nerr_mismatches": int((nerr != nerr_p).sum()),
               "frames_wrong_last": int(err[-1].sum())}
        emit(row)
        check(kern.launches == {"fused_nms_stats": 1}, f"{cid}: launches {kern.launches}")
        check(row["err_mismatches"] == 0 and row["nerr_mismatches"] == 0,
              f"{cid}: counters differ from the plain version")

    # (id, code, sharing, decoding type, T, B, weights, SNR, kernels); (l) is
    # the early stop's main path, boosted30 at T=30
    stop_cases = [
        ("f_wman_333_qms_base20", WMAN, (3, 3, 3), 2, 20, MAIN_B, "base20", 4.0, "ED"),
        ("g_mackay_333_ms_rand", "MACKAY_N96_K48", (3, 3, 3), 1, 5, 16384, "rand", 3.5, "ED"),
        ("h_wifi_303_qms_rand", "802_11n_N648_R56_z27", (3, 0, 3), 2, 8, 16384, "rand", 4.0, "D"),
        ("l_wman_333_qms_boosted30", WMAN, (3, 3, 3), 2, T_BOOST, MAIN_B, "boosted30", 4.0, "E"),
    ]
    for cid, cname, sharing, dec, T, B, wkind, snr, kernels in stop_cases:
        graph, spec, stacked, llr = case_inputs(cname, sharing, dec, T, B, "scale", wkind, snr)
        fixed = FusedNMSKernel(graph, DecoderConfig(decoding_type=dec), spec)
        _, err_f, nerr_f = fixed.decode_stats(stacked, llr)
        if "E" in kernels:  # B2, the genie early stop
            es = FusedNMSKernel(graph, DecoderConfig(decoding_type=dec, early_stop=True), spec)
            app, err, nerr = es.decode_stats(stacked, llr)
            app_p, err_p, nerr_p = es.decode_stats_plain(stacked, llr)
            torch.cuda.synchronize()
            uncor = err.all(dim=0)
            row = {"phase": "kernel_vs_plain", "kernel": "fused_nms_early_stop",
                   "case": cid, "B": B, "T": T, "group": es.group, "snr_db": snr,
                   "max_abs_app_diff": app_check(cid, dec, app, app_p, "fused_nms_early_stop"),
                   "err_mismatches": int((err != err_p).sum()),
                   "nerr_mismatches": int((nerr != nerr_p).sum()),
                   "uncor_vs_fixed_mismatches": int((uncor != err_f.all(dim=0)).sum()),
                   "uncor": int(uncor.sum()),
                   "word_iters": early_stop_word_iters(err, es.group),
                   "word_iters_fixed": B * T}
            emit(row)
            check(es.launches == {"fused_nms_early_stop": 1}, f"{cid}: launches {es.launches}")
            check(row["err_mismatches"] == 0 and row["nerr_mismatches"] == 0,
                  f"{cid}: early-stop counters differ from the grouped plain version")
            check(row["uncor_vs_fixed_mismatches"] == 0,
                  f"{cid}: early-stop genie mask differs from the fixed-T kernel's")
        if "D" not in kernels:  # B3, the syndrome stop
            continue
        dep = FusedNMSKernel(graph, DecoderConfig(decoding_type=dec), spec)
        out = dep.decode_deploy(stacked, llr)
        ref = dep.decode_deploy_plain(stacked, llr)
        torch.cuda.synchronize()
        app, wrong, nerr_d, iters, fail = out
        idx = (iters.long() - 1)[None]
        row = {"phase": "kernel_vs_plain", "kernel": "fused_nms_deploy", "case": cid,
               "B": B, "T": T, "snr_db": snr,
               "max_abs_app_diff": app_check(cid, dec, app, ref[0], "fused_nms_deploy"),
               "mismatches": {n: int((x != y).sum()) for n, x, y in
                              zip(("wrong", "bit_errors", "iters", "detected_fail"),
                                  out[1:], ref[1:])},
               "wrong_vs_stats_row": int((wrong != err_f.gather(0, idx)[0]).sum()),
               "nerr_vs_stats_row": int((nerr_d != nerr_f.gather(0, idx)[0]).sum()),
               "genie_not_wrong": int((err_f.all(dim=0) & ~wrong).sum()),
               "fail_not_wrong": int((fail & ~wrong).sum()),
               "mean_iters": float(iters.float().mean()), "detected_fail": int(fail.sum()),
               "undetected": int((wrong & ~fail).sum())}
        emit(row)
        check(dep.launches == {"fused_nms_deploy": 1}, f"{cid}: launches {dep.launches}")
        check(not any(row["mismatches"].values()),
              f"{cid}: deploy outputs differ from the plain version")
        check(row["wrong_vs_stats_row"] == 0 and row["nerr_vs_stats_row"] == 0,
              f"{cid}: deploy outputs differ from the stats kernel's row iters-1")
        check(row["genie_not_wrong"] == 0 and row["fail_not_wrong"] == 0,
              f"{cid}: genie failures not within wrong, or detected_fail without wrong")

    sp_cases = [  # (id, code, sharing, T, B, weights, SNR); (i) is the BP path's
        ("i_wman_000_sp_bp", WMAN, (0, 0, 0), 20, MAIN_B, "ones", 4.0),
        ("j_wman_303_sp_rand", WMAN, (3, 0, 3), 20, 16384, "rand", 3.0),
        ("k_mackay_303_sp_rand", "MACKAY_N96_K48", (3, 0, 3), 5, 16384, "rand", 2.5),
    ]
    for cid, cname, sharing, T, B, wkind, snr in sp_cases:
        graph, spec, stacked, llr = case_inputs(cname, sharing, 0, T, B, "scale", wkind, snr)
        kern = FusedNMSKernel(graph, DecoderConfig(decoding_type=0), spec)
        app, err, nerr = kern.decode_stats(stacked, llr)
        app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
        torch.cuda.synchronize()
        words_off = int(((err != err_p) | (nerr != nerr_p)).any(dim=0).sum())
        row = {"phase": "kernel_vs_plain", "kernel": "fused_nms_stats_sp", "case": cid,
               "B": B, "T": T, "snr_db": snr,
               "max_abs_app_diff": app_check(cid, 0, app, app_p, "fused_nms_stats_sp"),
               "words_with_counter_mismatch": words_off,
               "uncor": int(err.all(dim=0).sum())}
        emit(row)
        check(kern.launches == {"fused_nms_stats_sp": 1}, f"{cid}: launches {kern.launches}")
        check(words_off <= 0.001 * B, f"{cid}: {words_off} words' counters differ")

    # ---- 4. end to end: each path -------------------------------------------------
    def simulator(spec, cfg, batch=MAIN_B, stop="genie", dec=2):
        decoder = NMSDecoder(wman, cfg, spec, graph=wman_graph, device=dev)
        channel = AWGNChannel(wman, decoding_type=dec, device=dev)
        return FERSimulator(decoder, channel, batch=batch, stop=stop)

    def drive(label, sim, params, seed, snr=4.0):
        """One run_point of a path, launch counts zeroed just before."""
        sim.decoder.kernel.launches.clear()
        pt = sim.run_point(params, snr, torch.Generator(device=dev).manual_seed(seed),
                           max_frames=MAX_FRAMES, target_frame_errors=None)
        launches = dict(sim.decoder.kernel.launches)
        emit({"phase": "end_to_end", "path": label, **vars(pt),
              "genie_errors": round(pt.fer_genie * pt.frames) if pt.fer_genie == pt.fer_genie else None,
              "kernel_launches": launches})
        check(pt.frames == MAX_FRAMES, f"{label}: {pt.frames} frames, wanted {MAX_FRAMES}")
        check(sum(launches.values()) == MAX_FRAMES // MAIN_B and len(launches) == 1,
              f"{label}: launches {launches} for {MAX_FRAMES // MAIN_B} batches")
        return pt, launches

    main_launches = {}
    sim_fixed = simulator(spec20, DecoderConfig())
    pt, main_launches["fused_nms_stats"] = drive("base20 fixed T=20", sim_fixed, base20, 0)
    check(1.5e-4 <= pt.fer_genie <= 2.7e-4,
          f"base20 FER_genie {pt.fer_genie} outside [1.5e-4, 2.7e-4]")
    pt_ms, _ = drive("all-ones (plain min-sum) fixed T=20", sim_fixed,
                     init_weights(spec20, wman_graph, device=dev), 1)
    check(pt_ms.fer_genie >= 2.0 * pt.fer_genie,
          f"plain min-sum FER {pt_ms.fer_genie} not 2x base20's {pt.fer_genie}")

    pt_es, _ = drive("base20 early stop", simulator(spec20, DecoderConfig(early_stop=True)),
                     base20, 0)
    check(pt_es.fer_genie == pt.fer_genie == PR1_FER_GENIE,
          f"early-stop FER_genie {pt_es.fer_genie}, fixed {pt.fer_genie}, "
          f"wanted {PR1_FER_GENIE}")
    sim_boost = simulator(spec30, DecoderConfig(early_stop=True))
    pt_b, main_launches["fused_nms_early_stop"] = drive(
        "boosted30 early stop", sim_boost, boosted30, 0)
    pt_bf, _ = drive("boosted30 fixed T=30", simulator(spec30, DecoderConfig()), boosted30, 0)
    check(pt_b.fer_genie <= 0.8 * pt.fer_genie,
          f"boosted30 FER_genie {pt_b.fer_genie} not <= 0.8x base20's {pt.fer_genie}")
    check(pt_b.fer_genie == pt_bf.fer_genie,
          f"boosted30 FER_genie {pt_b.fer_genie} with early stop, {pt_bf.fer_genie} without")

    pt_d, main_launches["fused_nms_deploy"] = drive(
        "base20 syndrome stop", simulator(spec20, DecoderConfig(), stop="syndrome"), base20, 0)
    check(pt_d.fer_last >= pt.fer_genie,
          f"syndrome FER_last {pt_d.fer_last} below base20 FER_genie {pt.fer_genie}")
    check(pt_d.fer_undetected <= pt_d.fer_last, "FER_undetected above FER_last")
    check(3.05 <= pt_d.avg_iters <= 3.35, f"mean iterations {pt_d.avg_iters} outside [3.05, 3.35]")

    spec_bp = WeightSpec(sharing=(0, 0, 0), n_iters=T_MAIN)
    pt_sp, main_launches["fused_nms_stats_sp"] = drive(
        "belief propagation (SP) fixed T=20", simulator(spec_bp, DecoderConfig(decoding_type=0),
                                                        dec=0),
        init_weights(spec_bp, wman_graph, device=dev), 0)
    check(pt_sp.fer_genie <= pt_ms.fer_genie,
          f"SP FER_genie {pt_sp.fer_genie} above plain min-sum's {pt_ms.fer_genie}")

    # ---- 5. harvest ------------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out_file = os.path.join(tmp, "Uncor.txt")
        cfg = ExperimentConfig(code=WMAN, sharing=(3, 3, 3), iters_max=T_MAIN,
                               snrs=[4.2], seed=0)
        t0 = time.perf_counter()
        words = run_collection(cfg, weight_file=f"{WMAN}_base20", target_words=256,
                               batch=MAIN_B, out_file=out_file, device=dev)
        harvest_s = time.perf_counter() - t0
        file_rows = read_uncor_file(out_file).shape[0]
    llr_h = torch.as_tensor(words.T.copy(), device=dev)
    _, err_h, _ = FusedNMSKernel(wman_graph, DecoderConfig(), spec20).decode_stats(
        stack_weights(spec20, base20), llr_h)
    _, err_hb, _ = FusedNMSKernel(wman_graph, DecoderConfig(), spec30).decode_stats(
        stack_weights(spec30, boosted30), llr_h)
    rescued = int((~err_hb.all(dim=0)).sum())
    emit({"phase": "harvest", "snr_db": 4.2, "words": int(words.shape[0]),
          "file_rows": file_rows, "seconds": harvest_s,
          "all_wrong_every_iteration": bool(err_h.all()),
          "rescued_by_boosted30": rescued, "rescued_share": rescued / max(len(words), 1)})
    check(words.shape[0] >= 256, f"harvested {words.shape[0]} words, wanted 256")
    check(file_rows == words.shape[0], f"{file_rows} rows on file, {words.shape[0]} returned")
    check(bool(err_h.all()), "a harvested word decodes at some iteration")
    check(rescued >= 0.25 * words.shape[0], f"boosted30 rescued {rescued} of {len(words)}")

    # ---- 6. timing ----------------------------------------------------------------
    channel = AWGNChannel(wman, device=dev)
    st20, st30 = stack_weights(spec20, base20), stack_weights(spec30, boosted30)

    def llr_at(snr, B=MAIN_B, dec=2):
        ch = channel if dec == 2 else AWGNChannel(wman, decoding_type=dec, device=dev)
        return ch.sample(gen, torch.full((B,), float(wman.snr_sigmas([snr])[0]), device=dev))

    fixed20 = FusedNMSKernel(wman_graph, DecoderConfig(), spec20)
    es20 = FusedNMSKernel(wman_graph, DecoderConfig(early_stop=True), spec20)
    es30 = FusedNMSKernel(wman_graph, DecoderConfig(early_stop=True), spec30)
    dep20 = FusedNMSKernel(wman_graph, DecoderConfig(), spec20)
    sp20 = FusedNMSKernel(wman_graph, DecoderConfig(decoding_type=0), spec_bp)
    st_bp = stack_weights(spec_bp, init_weights(spec_bp, wman_graph, device=dev))
    G = es20.group
    timing, bounds = {}, {}

    for B in (16384, MAIN_B, 262144):  # B1, as in PR 1
        llr = llr_at(4.0, B)
        timing[f"fixed20_ms_B{B}"] = time_ms(lambda: fixed20.decode_stats(st20, llr),
                                             reps=10 if B < 262144 else 4)
    llr = llr_at(4.0)
    timing["fixed20_plain_ms"] = time_ms(lambda: fixed20.decode_stats_plain(st20, llr),
                                         reps=2, warmup=1)
    bounds["fused_nms_stats"] = bound(wman_graph, spec20, MAIN_B)

    for snr in (4.0, 5.0):  # B2 against B1 on the same LLRs (base20, T=20)
        llr = llr_at(snr)
        timing[f"early_stop20_ms_{snr}dB"] = time_ms(lambda: es20.decode_stats(st20, llr), reps=10)
        timing[f"fixed20_ms_{snr}dB"] = time_ms(lambda: fixed20.decode_stats(st20, llr), reps=10)
        timing[f"early_stop20_word_iters_{snr}dB"] = early_stop_word_iters(
            es20.decode_stats(st20, llr)[1], G)
    llr = llr_at(4.0)  # B2 on its main path: boosted30, T=30
    timing["early_stop30_ms"] = time_ms(lambda: es30.decode_stats(st30, llr), reps=10)
    timing["early_stop30_plain_ms"] = time_ms(lambda: es30.decode_stats_plain(st30, llr),
                                              reps=2, warmup=1)
    wi = early_stop_word_iters(es30.decode_stats(st30, llr)[1], G)
    bounds["fused_nms_early_stop"] = bound(wman_graph, spec30, MAIN_B, word_iters=wi)

    llr = llr_at(4.0)  # B3 on its main path: base20, T=20
    timing["deploy20_ms"] = time_ms(lambda: dep20.decode_deploy(st20, llr), reps=10)
    timing["deploy20_plain_ms"] = time_ms(lambda: dep20.decode_deploy_plain(st20, llr),
                                          reps=2, warmup=1)
    G_dep = launch_shape(wman_graph, True, deploy=True)[0]
    wi = deploy_word_iters(dep20.decode_deploy(st20, llr)[3], G_dep)
    bounds["fused_nms_deploy"] = bound(wman_graph, spec20, MAIN_B, word_iters=wi,
                                       out_bytes_per_word=1 + 4 + 4 + 1, syndrome=True)

    for B in (16384, MAIN_B):  # B1-SP on its path: belief propagation, T=20
        llr = llr_at(4.0, B, dec=0)
        timing[f"sp20_ms_B{B}"] = time_ms(lambda: sp20.decode_stats(st_bp, llr), reps=10)
        timing[f"sp20_plain_ms_B{B}"] = time_ms(lambda: sp20.decode_stats_plain(st_bp, llr),
                                                reps=2, warmup=1)
    bounds["fused_nms_stats_sp"] = bound(wman_graph, spec_bp, MAIN_B, sp=True)
    G_fixed, threads = launch_shape(wman_graph, True)
    smem_traffic = (T_MAIN * MAIN_B * 4 * wman_graph.E * wman.z * 6)  # bytes
    emit({"phase": "timing", "card": smi, **timing,
          "run_point_frames_per_sec": {"base20_fixed": pt.frames_per_sec,
                                       "base20_early_stop": pt_es.frames_per_sec,
                                       "boosted30_early_stop": pt_b.frames_per_sec,
                                       "boosted30_fixed": pt_bf.frames_per_sec,
                                       "base20_syndrome": pt_d.frames_per_sec,
                                       "bp_sp": pt_sp.frames_per_sec},
          "bounds": bounds, "words_per_block": G_fixed, "threads": threads,
          "words_per_block_deploy": G_dep,
          "smem_ms_this_design_fixed20": smem_traffic / SMEM_BYTES_PER_S * 1e3})

    # ---- 7. summary -----------------------------------------------------------------
    src = "ldpc_error_floor_tpu_torch/csrc/fused_nms_stats.cu"
    rows = [  # (name, replaces, ms, plain ms)
        ("fused_nms_stats", "ldpc_error_floor_tpu/ops/pallas_decoder.py:435",
         timing[f"fixed20_ms_B{MAIN_B}"], timing["fixed20_plain_ms"]),
        ("fused_nms_early_stop", "ldpc_error_floor_tpu/ops/pallas_decoder.py:747",
         timing["early_stop30_ms"], timing["early_stop30_plain_ms"]),
        ("fused_nms_deploy", "ldpc_error_floor_tpu/ops/pallas_decoder.py:692",
         timing["deploy20_ms"], timing["deploy20_plain_ms"]),
        ("fused_nms_stats_sp", "ldpc_error_floor_tpu/ops/pallas_decoder.py:567",
         timing[f"sp20_ms_B{MAIN_B}"], timing[f"sp20_plain_ms_B{MAIN_B}"]),
    ]
    emit({"kernels": [{
        "name": kname, "route": "cuda", "source": src, "replaces": replaces,
        "launches": main_launches[kname][kname], "max_abs_err": max_err[kname],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[kname]["bound_ms"],
        "bound_by": bounds[kname]["bound_by"], "library_ms": None}
        for kname, replaces, ms, plain_ms in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

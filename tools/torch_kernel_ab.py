#!/usr/bin/env python3
"""Time the CUDA kernels of several copies of the PyTorch port against each
other on one card, in turns, on the same inputs.

    python tools/torch_kernel_ab.py --tree new=. --tree old=build/parent \
        --order old,new,new,old [--kernels all|train|train_sp|decode|sp_wide|sp_shapes|
        sp_train_shapes|sampler] [--sass] \
        [--out build/kernel_ab.json]

A tree is a directory that holds a copy of `ldpc_error_floor_tpu_torch/`
(and, for the build directory, a `pyproject.toml`; `git archive <commit>
ldpc_error_floor_tpu_torch pyproject.toml` gives one).  Each entry of
`--order` runs in a process of its own, so one package is imported per
process; it builds that tree's kernels, makes the inputs from fixed seeds
(the same words and weights in every tree) and times, with CUDA events:

- train: B4 and B5 (`FusedTrainKernel._forward` with the residual streams,
  `_backward`) at batch 32768 on the base block (wman (3,0,3), T=20, QMS
  q_bit 5, APP window t0=19), the post block ((3,3,3) with UCN, T=30,
  t0=29) and a per-check block ((2,2,2) with UCN, T=20, t0=19), and
  B4-SP/B5-SP on the neural BP base block (the base block with SP): B4
  streaming and, under no_grad, alone (the APPs only), B5 twice (whether
  its gradients are bit-identical); then one whole train step on the
  neural BP base block and on the base block (`make_epoch_step`: sampling,
  B4, loss, B5, Adam, clip), the base step's host time (the time to issue
  a step, before the card is waited for), a `torch.profiler` trace of it
  (the card's time per kernel, the host's time in CUDA runtime calls) and
  the PyTorch operations in it that wait for the card
  (`torch.cuda.set_sync_debug_mode`);
- all: also B1 (fixed T=20, base20 weights), B2 (genie early stop, T=30,
  boosted30 weights; and base20 at T=20 at 4.0, 5.0 and 5.5 dB), B3
  (syndrome stop, T=20; also at 5.0 and 5.5 dB), B1-SP (BP, T=20) and the
  SP early-stop and syndrome-stop instances on its inputs, and the MS float
  state's B1 (MS, base20 weights), each at batch 65536 and 4.0 dB unless
  noted; the labelled instances of B1, B2 (T=30), B3 and B1-SP on 65536
  random codewords (the port's `Encoder`, BPSK of the encoded word) as
  labels, and B1 with `track_syndrome` on the zero word (a tree whose
  decoder refuses them records the refusal under ``refused``); a host
  read of 8 batches of 65536 (base20 at 5.5 dB; the 5G rate-1/2 z 64 code
  with its 50-iteration weights at 3.0 dB, T=50, target 10): B2 once over
  the read, totals only (`decode_read_totals`), against 8 launches of B2
  whose rows are reduced (`read_totals_of_rows`), as the simulator reduced
  them before (a tree without them records the refusal);
  `FERSimulator.run_point` frames/s on the base20 fixed-T, base20
  early-stop, boosted30 early-stop, base20 syndrome-stop and BP fixed-T
  paths (4.0 dB, 2^20 frames, seed 0); and the deep anchor: base20 with
  the early stop at 5.5 dB over 2^25 frames, seed 0, its genie error count
  and frames/s; each point twice on one generator, cold (a new simulator:
  the decoder's first use and, where the tree has one, the host loop's
  CUDA graph capture) and warm (``frames_per_sec``);
- sp_wide: B1-SP (batch 65536, 4.0 dB) on the bundled codes other than
  wman (`SP_CODES`), and B4-SP and B5-SP (the neural BP base block, batch
  32768) on those whose checks pass SP's chunk of 16 slots (802.11n, check
  degree 22; BCH_63_51, 28; Polar_64_48, 64); `all` runs it too;
- sp_shapes: B1-SP on wman and `SP_CODES` at every launch shape its
  kernel takes (G words of a power of two, threads a multiple of G and of
  the warp, one resident block at least), with its resident blocks per SM
  and whether its outputs equal those at the wrapper's own shape;
- train_sp: the neural BP part of `train` alone (B4-SP, B5-SP and the
  neural BP train step);
- sp_train_shapes: B4-SP and B5-SP (the neural BP base block, batch
  32768) on wman, 802.11n and MacKay at every launch shape their kernels
  take (as sp_shapes; B5-SP at each G on streams of that tile width), with
  B4-SP's outputs against those at its own shape and B5-SP's gradient
  sums, for one tree (~2 min);
- decode: the decode part of `all` alone;
- sampler: the channel sampler and what it feeds: `AWGNChannel.sample` at
  65536 words (QMS q_bit 5, 4.0 dB) and the random-codeword step's folded
  LLRs (`FERSimulator._sample`), timed with the digest of one draw from a
  fixed seed; run_point frames/s, cold and warm, of base20 with the early
  stop and with the syndrome stop (4.0 dB, 2^20 frames) and of the deep
  anchor (5.5 dB, 2^25 frames), at K = 8 batches per host read, as
  `chip_smoke.py` runs them; and one whole base train step (as `train`).

Each run prints one JSON line (a run that fails is reported, the others
go on, and the tool exits 1): the times, the ptxas report of each library
it built, and a digest of every output (B4's APPs and residual streams,
the streams in the logical layout [T, rows, B] so that trees whose tile
widths differ compare, and the decode outputs must agree between trees
that decode alike; B5's gradients are summarised by their sums).  `--sass` also writes `cuobjdump -sass` of each tree's
libraries to the output directory.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

WMAN = "wman_N0576_R34_z24"
G5_64 = "5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640"
READ_K = 8  # batches of a host read
TRAIN_B = 32768
DECODE_B = 65536
STEPS = 5  # train steps per timed epoch
SP_CODES = {  # B1-SP beyond wman: the name in times_ms, and whether B4-SP runs too
    "802_11n_N648_R56_z27": ("802", True),
    "BCH_63_51": ("BCH", True),
    "Polar_64_48": ("Polar", True),
    "MACKAY_N96_K48": ("MacKay", False),
    G5_64: ("5G50z64", False),
    "5G_LDPC_R0.73_n_dec2304_n2112_k1536_z72_s1537_1584": ("5G73z72", False),
}


# ----- one run, in its own process ------------------------------------------------

def digest(x) -> str:
    return hashlib.sha256(x.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def worker(tree: Path, kernels: str, sass_dir: str) -> dict:
    import torch
    sys.path.insert(0, str(tree))
    import ldpc_error_floor_tpu_torch as pkg
    assert Path(pkg.__file__).resolve().is_relative_to(tree.resolve()), pkg.__file__
    from ldpc_error_floor_tpu_torch.ops import fused_decoder, fused_train

    dev = torch.device("cuda")
    out = {"tree": str(tree), "times_ms": {}, "digests": {}, "grad_sums": {}}
    t_build = time.perf_counter()
    libs = [] if kernels == "decode" else [("fused_nms_train.cu", fused_train.load_library)]
    if kernels not in ("train", "train_sp", "sp_train_shapes"):
        libs.append(("fused_nms_stats.cu", fused_decoder.load_library))
    if importlib.util.find_spec("ldpc_error_floor_tpu_torch.ops.awgn_llr") is not None:
        from ldpc_error_floor_tpu_torch.ops import awgn_llr  # the sampler's kernel
        libs.append(("awgn_llr.cu", awgn_llr.load_library))
    out["ptxas"] = {}
    for src, load in libs:
        lib, log = load()
        out["ptxas"][src] = [ln.strip() for ln in log.splitlines()
                             if "Compiling entry" in ln or "registers" in ln
                             or "spill" in ln]
        if sass_dir:
            cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            res = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True,
                                 text=True)
            name = Path(tree).resolve().name or "tree"
            Path(sass_dir, f"sass_{name}_{Path(lib._name).stem}.txt").write_text(
                res.stdout + res.stderr)
    out["build_s"] = time.perf_counter() - t_build
    gen = torch.Generator(device=dev).manual_seed(2024)
    if kernels in ("all", "train", "train_sp"):
        train_runs(out, gen, sp_only=kernels == "train_sp")
    if kernels in ("all", "decode"):
        decode_runs(out, gen)
    if kernels in ("all", "sp_wide"):
        sp_wide_runs(out, gen)
    if kernels == "sp_shapes":
        sp_shape_runs(out, gen)
    if kernels == "sp_train_shapes":
        sp_train_shape_runs(out, gen)
    if kernels == "sampler":
        sampler_runs(out, gen)
    return out


def time_ms(fn, reps, warmup=2):
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


def logical(stream, B: int):
    """A residual stream [tiles, T, rows, W] in the logical layout [T, rows,
    B] (its digest does not depend on the tile width)."""
    if stream is None:
        return None
    tiles, T, rows, W = stream.shape
    return stream.permute(1, 2, 0, 3).reshape(T, rows, tiles * W)[:, :, :B]


def train_pair(out: dict, name: str, kern, w3, llr, alone: bool = False) -> None:
    """Time B4 (streaming; with `alone` also under no_grad, the APPs alone)
    and B5 on one batch with the soft-FER loss at eta 0, and record the
    digests of B4's APPs and residual streams (logical layout) and the sums
    of B5's gradients, and whether two B5 launches are bit-identical."""
    import torch
    from ldpc_error_floor_tpu_torch.training import multi_iteration_loss
    B = llr.shape[1]
    out["times_ms"][f"{name}_fwd"] = time_ms(lambda: kern._forward(w3, llr, True), 5)
    if alone:
        out["times_ms"][f"{name}_fwd_alone"] = time_ms(
            lambda: kern._forward(w3, llr, False), 5)
    apps_pre, hist, cres = kern._forward(w3, llr, True)
    out["digests"][f"{name}_fwd_apps"] = digest(apps_pre)
    out["digests"][f"{name}_fwd_hist"] = digest(logical(hist, B))
    if cres is not None:
        out["digests"][f"{name}_fwd_cres"] = digest(logical(cres, B))
    a = torch.clamp(apps_pre, -20.0, 20.0).requires_grad_(True)
    multi_iteration_loss(a, torch.zeros((a.shape[1], B), device=a.device), 2,
                         0.0).backward()
    g_apps = a.grad.contiguous()
    out["times_ms"][f"{name}_bwd"] = time_ms(
        lambda: kern._backward(w3, llr, hist, cres, apps_pre, g_apps), 5)
    grads = kern._backward(w3, llr, hist, cres, apps_pre, g_apps)
    again = kern._backward(w3, llr, hist, cres, apps_pre, g_apps)
    out["grad_sums"][name] = [None if g is None else float(g.double().sum())
                              for g in grads]
    out.setdefault("bwd_bit_identical", {})[name] = all(
        g is None or torch.equal(g, h) for g, h in zip(grads, again))


def train_epoch(spec, dt: int):
    """(epoch, params, optimizer): STEPS whole train steps on wman at
    TRAIN_B (`make_epoch_step`: sampling, B4, loss, B5, Adam, clip) from
    all-ones weights, soft FER, eta 0, the APP window t0 = T - 1."""
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.channel.awgn import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import DecoderConfig, NMSDecoder, init_weights
    from ldpc_error_floor_tpu_torch.pipelines import base_config_wman
    from ldpc_error_floor_tpu_torch.training import make_epoch_step, make_optimizer
    dev = torch.device("cuda")
    wman = get_code(WMAN)
    graph = TannerGraph(wman)
    sig_train = torch.as_tensor(
        mix_sigma_lanes(wman.snr_sigmas(base_config_wman().snrs), TRAIN_B), device=dev)
    T = spec.n_iters
    dec = NMSDecoder(wman, DecoderConfig(decoding_type=dt, app_t0=T - 1), spec,
                     graph=graph, device=dev)
    params = init_weights(spec, graph, device=dev)
    opt = make_optimizer(params, 1e-2)
    epoch = make_epoch_step(dec, spec, 2, 0, T, 0, n_steps=STEPS,
                            labels=torch.zeros((wman.n_full, TRAIN_B), device=dev),
                            channel=AWGNChannel(wman, decoding_type=dt, device=dev),
                            sigmas=sig_train, static_etha=0.0)
    return epoch, params, opt


def run_point(spec, params, early_stop: bool, snr: float, frames: int,
              stop: str = "genie", dec: int = 2, inner_steps: int = 1):
    """A run_point on wman at DECODE_B twice on one generator from seed 0:
    (the cold run's frames/s, the warm run's point)."""
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import DecoderConfig, NMSDecoder
    from ldpc_error_floor_tpu_torch.sim import FERSimulator
    dev = torch.device("cuda")
    wman = get_code(WMAN)
    decoder = NMSDecoder(wman, DecoderConfig(decoding_type=dec, early_stop=early_stop),
                         spec, graph=TannerGraph(wman), device=dev)
    sim = FERSimulator(decoder, AWGNChannel(wman, decoding_type=dec, device=dev),
                       batch=DECODE_B, stop=stop, inner_steps=inner_steps)
    g = torch.Generator(device=dev)
    cold = sim.run_point(params, snr, g.manual_seed(0), max_frames=frames,
                         target_frame_errors=None)
    return cold.frames_per_sec, sim.run_point(params, snr, g.manual_seed(0),
                                              max_frames=frames, target_frame_errors=None)


def point_row(cold_fps: float, pt) -> dict:
    row = {"frames": pt.frames, "frames_per_sec": pt.frames_per_sec,
           "frames_per_sec_cold": cold_fps, "frame_errors": round(pt.fer_last * pt.frames)}
    if pt.avg_iters is not None:
        row["mean_iters"] = pt.avg_iters
    else:
        row["genie_errors"] = round(pt.fer_genie * pt.frames)
    return row


def sampler_runs(out: dict, gen) -> None:
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder, WeightSpec,
                                                   load_params)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator
    dev = torch.device("cuda")
    wman = get_code(WMAN)
    graph = TannerGraph(wman)
    sigma = float(wman.snr_sigmas([4.0])[0])
    sig = torch.full((DECODE_B,), sigma, device=dev)
    ch = AWGNChannel(wman, device=dev)
    spec20 = WeightSpec(sharing=(3, 3, 3), n_iters=20)
    sim = FERSimulator(NMSDecoder(wman, DecoderConfig(), spec20, graph=graph, device=dev),
                       ch, batch=DECODE_B, codewords="random")
    for name, fn in (("sample", lambda g: ch.sample(g, sig)),
                     ("sample_random_words_fold", lambda g: sim._sample(g, sigma))):
        out["times_ms"][name] = time_ms(lambda: fn(gen), 50)
        out["digests"][name] = digest(fn(torch.Generator(device=dev).manual_seed(7)))
    base20 = load_params(spec20, graph, f"{WMAN}_base20", device=dev)
    out["run_point"] = {}
    for name, es, stop, snr, frames in (
            ("base20_early_stop", True, "genie", 4.0, 2 ** 20),
            ("base20_syndrome", False, "syndrome", 4.0, 2 ** 20),
            ("deep_base20_early_stop_5.5dB", True, "genie", 5.5, 2 ** 25)):
        out["run_point"][name] = point_row(*run_point(spec20, base20, es, snr, frames, stop,
                                                      inner_steps=8))
    epoch, params, opt = train_epoch(WeightSpec(sharing=(3, 0, 3), n_iters=20), 2)
    out["times_ms"]["base_step"] = time_ms(lambda: epoch(params, opt, gen, 0.0),
                                           2, warmup=1) / STEPS


def train_runs(out: dict, gen, sp_only: bool = False) -> None:
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.channel.awgn import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import DecoderConfig, WeightSpec
    from ldpc_error_floor_tpu_torch.ops import fused_train
    from ldpc_error_floor_tpu_torch.pipelines import base_config_wman
    dev = torch.device("cuda")
    wman = get_code(WMAN)
    graph = TannerGraph(wman)

    def rand_weights(spec, lo=0.7, hi=1.3):
        return {k: None if spec.dim(k, graph) == 0 else
                (lo + (hi - lo) * torch.rand((spec.n_iters, spec.dim(k, graph)),
                                             generator=gen, device=dev)).contiguous()
                for k in ("cn", "ucn", "vn")}

    sig_train = torch.as_tensor(
        mix_sigma_lanes(wman.snr_sigmas(base_config_wman().snrs), TRAIN_B), device=dev)
    blocks = {  # name: (spec, decoding type)
        "base": (WeightSpec(sharing=(3, 0, 3), n_iters=20), 2),
        "post": (WeightSpec(sharing=(3, 3, 3), n_iters=30, fixed_iter=20), 2),
        "pcheck": (WeightSpec(sharing=(2, 2, 2), n_iters=20), 2),
        "base_sp": (WeightSpec(sharing=(3, 0, 3), n_iters=20), 0),
    }
    for bname, (spec, dt) in blocks.items():
        if sp_only and dt != 0:
            continue
        T = spec.n_iters
        kern = fused_train.FusedTrainKernel(
            graph, DecoderConfig(decoding_type=dt, app_t0=T - 1), spec)
        ws = rand_weights(spec)
        w3 = (ws["cn"], ws["ucn"], ws["vn"])
        llr = AWGNChannel(wman, decoding_type=dt, device=dev).sample(gen, sig_train)
        train_pair(out, bname, kern, w3, llr, alone=True)
        torch.cuda.empty_cache()

    # one whole train step on the base block and the neural BP base block,
    # as chip_smoke.py times it
    for bname in ("base_sp",) if sp_only else ("base_sp", "base"):
        spec, dt = blocks[bname]
        epoch, params, opt = train_epoch(spec, dt)
        out["times_ms"][f"{bname}_step"] = time_ms(lambda: epoch(params, opt, gen, 0.0),
                                                   2, warmup=1) / STEPS
    if sp_only:
        return
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    epoch(params, opt, gen, 0.0)
    out["times_ms"]["base_step_host"] = (time.perf_counter() - t_host) * 1e3 / STEPS
    torch.cuda.synchronize()
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            epoch(params, opt, gen, 0.0)
            torch.cuda.synchronize()
        per, api = collections.Counter(), collections.Counter()
        for evt in prof.events():
            ms = evt.time_range.elapsed_us() / 1e3 / STEPS
            if evt.device_type == DeviceType.CUDA:
                per[evt.name[:72]] += ms
            elif evt.name.startswith("cuda"):  # the host's CUDA runtime calls
                api[evt.name] += ms
        out["base_step_trace_ms"] = {
            "device_busy": sum(per.values()),
            "kernels": dict(per.most_common(16)),
            "host_cuda_calls": dict(api.most_common(8)),
        }
    except Exception as exc:  # the trace is extra: a failure leaves the timings
        out["base_step_trace_ms"] = {"error": repr(exc)[:300]}
    # the PyTorch operations of a step that make the host wait for the card
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            epoch(params, opt, gen, 0.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["base_step_syncs"] = sorted({f"{Path(w.filename).name}:{w.lineno}: "
                                     f"{str(w.message)[:60]}" for w in caught})
    torch.cuda.synchronize()


def decode_runs(out: dict, gen) -> None:
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, WeightSpec,
                                                   compose_boosted_params,
                                                   init_weights, load_params,
                                                   stack_weights)
    from ldpc_error_floor_tpu_torch.ops import fused_decoder
    dev = torch.device("cuda")
    wman = get_code(WMAN)
    graph = TannerGraph(wman)
    spec20 = WeightSpec(sharing=(3, 3, 3), n_iters=20)
    spec30 = WeightSpec(sharing=(3, 3, 3), n_iters=30)
    base20 = load_params(spec20, graph, f"{WMAN}_base20", device=dev)
    boosted30 = compose_boosted_params(
        graph, spec20, base20, spec30,
        load_params(spec30, graph, f"{WMAN}_boosted30", device=dev))
    st20, st30 = stack_weights(spec20, base20), stack_weights(spec30, boosted30)
    spec_bp = WeightSpec(sharing=(0, 0, 0), n_iters=20)
    st_bp = stack_weights(spec_bp, init_weights(spec_bp, graph, device=dev))

    def llr_at(snr, dec=2):
        sig = torch.full((DECODE_B,), float(wman.snr_sigmas([snr])[0]), device=dev)
        return AWGNChannel(wman, decoding_type=dec, device=dev).sample(gen, sig)

    llr, llr_sp, llr_ms = llr_at(4.0), llr_at(4.0, dec=0), llr_at(4.0, dec=1)
    K = fused_decoder.FusedNMSKernel
    sp20 = K(graph, DecoderConfig(decoding_type=0), spec_bp)
    runs = {
        "b1_fixed20": (K(graph, DecoderConfig(), spec20), st20, llr, False),
        "b2_early_stop30": (K(graph, DecoderConfig(early_stop=True), spec30), st30,
                            llr, False),
        "b3_deploy20": (K(graph, DecoderConfig(), spec20), st20, llr, True),
        "b1sp_bp20": (sp20, st_bp, llr_sp, False),
        "b2sp_early_stop_bp20": (K(graph, DecoderConfig(decoding_type=0, early_stop=True),
                                   spec_bp), st_bp, llr_sp, False),
        "b3sp_deploy_bp20": (sp20, st_bp, llr_sp, True),
        "b1ms_fixed20": (K(graph, DecoderConfig(decoding_type=1), spec20), st20, llr_ms,
                         False),
    }
    es20 = K(graph, DecoderConfig(early_stop=True), spec20)
    dep20 = runs["b3_deploy20"][0]
    for snr in (4.0, 5.0, 5.5):
        llr_snr = llr_at(snr)
        runs[f"b2_early_stop20_{snr}dB"] = (es20, st20, llr_snr, False)
        if snr > 4.0:
            runs[f"b3_deploy20_{snr}dB"] = (dep20, st20, llr_snr, True)
    for name, (kern, st, x, deploy) in runs.items():
        fn = (lambda: kern.decode_deploy(st, x)) if deploy else (
            lambda: kern.decode_stats(st, x))
        out["times_ms"][name] = time_ms(fn, 10)
        out["digests"][name] = [digest(o) for o in fn()]

    # codeword labels and the syndrome flags (a generator of their own, so
    # the inputs above do not depend on them)
    from ldpc_error_floor_tpu_torch.codes import Encoder
    g_cw = torch.Generator(device=dev).manual_seed(5)
    words = Encoder(graph, device=dev).random_codewords(g_cw, DECODE_B)
    sig = torch.full((DECODE_B,), float(wman.snr_sigmas([4.0])[0]), device=dev)
    s_cw = g_cw.get_state()
    llr_cw = AWGNChannel(wman, device=dev).sample_codewords(g_cw, sig, words)
    g_cw.set_state(s_cw)
    llr_cw_sp = AWGNChannel(wman, decoding_type=0, device=dev).sample_codewords(
        g_cw, sig, words)
    extra = {  # name: (kernel, weights, LLRs, labels, deploy)
        "b1_fixed20_labels": (runs["b1_fixed20"][0], st20, llr_cw, words, False),
        "b2_early_stop30_labels": (runs["b2_early_stop30"][0], st30, llr_cw, words, False),
        "b3_deploy20_labels": (dep20, st20, llr_cw, words, True),
        "b1sp_bp20_labels": (sp20, st_bp, llr_cw_sp, words, False),
        "b1_fixed20_track_syndrome": (K(graph, DecoderConfig(track_syndrome=True), spec20),
                                      st20, llr, None, False),
    }
    for name, (kern, st, x, lab, deploy) in extra.items():
        fn = (lambda: kern.decode_deploy(st, x, lab)) if deploy else (
            lambda: kern.decode_stats(st, x, lab))
        try:
            out["times_ms"][name] = time_ms(fn, 10)
        except ValueError as e:  # a tree without these instances
            out.setdefault("refused", {})[name] = str(e)
            continue
        out["digests"][name] = [digest(o) for o in fn()]

    # a host read of READ_K batches: B2 once over it, totals only, against a
    # launch of B2 a batch whose rows are reduced (a generator of its own)
    g_rd = torch.Generator(device=dev).manual_seed(6)
    g5 = get_code(G5_64)
    g5_graph = TannerGraph(g5)
    spec50 = WeightSpec(sharing=(2, 2, 2), n_iters=50)
    st50 = stack_weights(spec50, load_params(spec50, g5_graph, f"{G5_64}_iter50",
                                             device=dev))
    reads = {  # name: (code, kernel, weights, SNR dB)
        "b2_read20_5.5dB": (wman, es20, st20, 5.5),
        "b2_read50_5G_3.0dB": (g5, K(g5_graph, DecoderConfig(target_node=10,
                                                             early_stop=True), spec50),
                               st50, 3.0),
    }
    for name, (code, kern, st, snr) in reads.items():
        if not hasattr(kern, "decode_read_totals"):
            out.setdefault("refused", {})[name] = "no decode_read_totals"
            continue
        sig = torch.full((DECODE_B,), float(code.snr_sigmas([snr])[0]), device=dev)
        ch = AWGNChannel(code, device=dev)
        x = torch.stack([ch.sample(g_rd, sig) for _ in range(READ_K)])
        for label, fn in (("_batches", kern.read_totals_of_rows), ("", kern.decode_read_totals)):
            out["times_ms"][name + label] = time_ms(lambda fn=fn: fn(st, x), 5)
            out["digests"][name + label] = [digest(fn(st, x))]
        del x

    out["run_point"] = {}
    bp = init_weights(spec_bp, graph, device=dev)
    for name, spec, params, es, stop, dec in (
            ("base20_fixed", spec20, base20, False, "genie", 2),
            ("base20_early_stop", spec20, base20, True, "genie", 2),
            ("boosted30_early_stop", spec30, boosted30, True, "genie", 2),
            ("base20_syndrome", spec20, base20, False, "syndrome", 2),
            ("bp_sp_fixed20", spec_bp, bp, False, "genie", 0)):
        out["run_point"][name] = point_row(*run_point(spec, params, es, 4.0, 2 ** 20,
                                                      stop, dec))
    out["run_point"]["deep_base20_early_stop_5.5dB"] = point_row(
        *run_point(spec20, base20, True, 5.5, 2 ** 25))


def sp_wide_runs(out: dict, gen) -> None:
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, WeightSpec,
                                                   init_weights, stack_weights)
    from ldpc_error_floor_tpu_torch.ops import fused_decoder, fused_train
    dev = torch.device("cuda")
    spec_bp = WeightSpec(sharing=(0, 0, 0), n_iters=20)
    spec_tr = WeightSpec(sharing=(3, 0, 3), n_iters=20)
    for cname, (short, train) in SP_CODES.items():
        code = get_code(cname)
        graph = TannerGraph(code)
        chan = AWGNChannel(code, decoding_type=0, device=dev)
        sig = float(code.snr_sigmas([4.0])[0])
        llr = chan.sample(gen, torch.full((DECODE_B,), sig, device=dev))
        st = stack_weights(spec_bp, init_weights(spec_bp, graph, device=dev))
        sp = fused_decoder.FusedNMSKernel(graph, DecoderConfig(decoding_type=0), spec_bp)
        out["times_ms"][f"b1sp_{short}"] = time_ms(lambda: sp.decode_stats(st, llr), 10)
        out["digests"][f"b1sp_{short}"] = [digest(o) for o in sp.decode_stats(st, llr)]
        del llr
        if not train:
            continue
        kern = fused_train.FusedTrainKernel(
            graph, DecoderConfig(decoding_type=0, app_t0=spec_tr.n_iters - 1), spec_tr)
        w3 = tuple(None if spec_tr.dim(k, graph) == 0 else
                   (0.7 + 0.6 * torch.rand((spec_tr.n_iters, spec_tr.dim(k, graph)),
                                           generator=gen, device=dev)).contiguous()
                   for k in ("cn", "ucn", "vn"))
        llr_tr = chan.sample(gen, torch.full((TRAIN_B,), sig, device=dev))
        pair = {"times_ms": {}, "digests": {}, "grad_sums": {}}
        train_pair(pair, short, kern, w3, llr_tr)
        out["times_ms"][f"b4sp_{short}"] = pair["times_ms"][f"{short}_fwd"]
        out["times_ms"][f"b5sp_{short}"] = pair["times_ms"][f"{short}_bwd"]
        out["digests"][f"b4sp_{short}"] = pair["digests"][f"{short}_fwd_apps"]
        out["digests"][f"b4sp_{short}_hist"] = pair["digests"][f"{short}_fwd_hist"]
        out["grad_sums"][f"b5sp_{short}"] = pair["grad_sums"][short]
        out.setdefault("bwd_bit_identical", {})[f"b5sp_{short}"] = (
            pair["bwd_bit_identical"][short])
        del llr_tr, pair
        torch.cuda.empty_cache()


def sp_shape_runs(out: dict, gen) -> None:
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, WeightSpec,
                                                   init_weights, stack_weights)
    from ldpc_error_floor_tpu_torch.ops import fused_decoder as fd
    dev = torch.device("cuda")
    spec_bp = WeightSpec(sharing=(0, 0, 0), n_iters=20)
    lib, _ = fd.load_library()
    out["sp_shapes"] = {}
    for cname in (WMAN, *SP_CODES):
        code = get_code(cname)
        graph = TannerGraph(code)
        sig = float(code.snr_sigmas([4.0])[0])
        llr = AWGNChannel(code, decoding_type=0, device=dev).sample(
            gen, torch.full((DECODE_B,), sig, device=dev))
        st = stack_weights(spec_bp, init_weights(spec_bp, graph, device=dev))
        sp = fd.FusedNMSKernel(graph, DecoderConfig(decoding_type=0), spec_bp)
        own = sp.launch_shape(fd.FIXED)
        ref = [digest(o) for o in sp.decode_stats(st, llr)]
        rows = []
        for G in (1, 2, 4, 8, 16, 32):
            smem = fd._smem_bytes(sp.N, sp.M, sp.z, sp.E, G, False, sp=True)
            items = max(sp.M, sp.N) * sp.z * G
            for threads in range(64, 1025, 32):
                if threads % G or threads > items + 31:
                    continue
                blocks = lib.fused_nms_resident_blocks(fd.FIXED, 1, 0, threads, smem)
                if blocks == 0:
                    continue
                sp.launch_shape = lambda mode, s=(G, threads, smem): s
                try:
                    ms = time_ms(lambda: sp.decode_stats(st, llr), 3, warmup=1)
                    same = [digest(o) for o in sp.decode_stats(st, llr)] == ref
                except RuntimeError as exc:  # past the kernel's launch bound
                    ms, same = None, repr(exc)[:80]
                rows.append([G, threads, blocks, ms, same])
        del sp.launch_shape
        out["sp_shapes"][cname] = {"own": list(own), "rows": rows}
        del llr
        torch.cuda.empty_cache()


def sp_train_shape_runs(out: dict, gen) -> None:
    """B4-SP and B5-SP (the neural BP base block, batch 32768) on wman,
    802.11n and MacKay at every launch shape their kernels take (blocks per
    SM as their shared memory allows, which the launch bound may cut): B4-SP
    with the streams' tile width its own plan gives, B5-SP at each G on
    streams of that tile width."""
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import DecoderConfig, WeightSpec
    from ldpc_error_floor_tpu_torch.ops import fused_decoder as fd
    from ldpc_error_floor_tpu_torch.ops import fused_train
    from ldpc_error_floor_tpu_torch.training import multi_iteration_loss
    dev = torch.device("cuda")
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=20)
    out["sp_train_shapes"] = {}
    for cname in (WMAN, "802_11n_N648_R56_z27", "MACKAY_N96_K48"):
        code = get_code(cname)
        graph = TannerGraph(code)
        N, M, z, E = code.N, code.M, code.z, graph.E
        kern = fused_train.FusedTrainKernel(
            graph, DecoderConfig(decoding_type=0, app_t0=spec.n_iters - 1), spec)
        own = kern.plan
        w3 = tuple(None if spec.dim(k, graph) == 0 else
                   (0.7 + 0.6 * torch.rand((spec.n_iters, spec.dim(k, graph)),
                                           generator=gen, device=dev)).contiguous()
                   for k in ("cn", "ucn", "vn"))
        sig = float(code.snr_sigmas([2.5])[0])
        llr = AWGNChannel(code, decoding_type=0, device=dev).sample(
            gen, torch.full((TRAIN_B,), sig, device=dev))
        ref = digest(kern._forward(w3, llr, False)[0])

        def shapes(smem_of):
            for G in (1, 2, 4, 8, 16, 32):
                smem = smem_of(G)
                if smem > fd._SMEM_LIMIT:
                    continue
                for threads in range(64, 1025, 32):
                    if threads % G == 0:  # past the kernel's bound the launch fails
                        blocks = fd._SMEM_PER_SM // (smem + fd._SMEM_RESERVED)
                        if blocks:
                            yield G, threads, smem, blocks

        fwd_rows, bwd_rows = [], []
        smem_fwd = lambda g: fd._smem_bytes(N, M, z, E, g, False, sp=True)
        for G, threads, smem, blocks in shapes(smem_fwd):
            kern.__dict__["plan"] = own._replace(fwd=(G, threads, smem))
            try:
                ms = time_ms(lambda: kern._forward(w3, llr, True), 3, warmup=1)
                same = digest(kern._forward(w3, llr, False)[0]) == ref
            except RuntimeError as exc:
                ms, same = None, repr(exc)[:80]
            fwd_rows.append([G, threads, blocks, ms, same])
        smem_bwd = lambda g: fused_train._smem_bwd(graph, spec, g, True)
        streams = {}
        for G, threads, smem, blocks in shapes(smem_bwd):
            kern.__dict__["plan"] = own._replace(bwd=(G, threads, smem))
            if G not in streams:
                streams.clear()
                torch.cuda.empty_cache()
                apps_pre, hist, cres = kern._forward(w3, llr, True)
                a = torch.clamp(apps_pre, -20.0, 20.0).requires_grad_(True)
                multi_iteration_loss(a, torch.zeros((a.shape[1], TRAIN_B), device=dev), 2,
                                     0.0).backward()
                streams[G] = (apps_pre, hist, cres, a.grad.contiguous())
            apps_pre, hist, cres, g_apps = streams[G]
            try:
                ms = time_ms(lambda: kern._backward(w3, llr, hist, cres, apps_pre, g_apps),
                             3, warmup=1)
                gsum = [None if g is None else float(g.double().sum()) for g in
                        kern._backward(w3, llr, hist, cres, apps_pre, g_apps)]
            except RuntimeError as exc:
                ms, gsum = None, repr(exc)[:80]
            bwd_rows.append([G, threads, blocks, ms, gsum])
        streams.clear()
        del kern.__dict__["plan"]
        out["sp_train_shapes"][cname] = {"own": [list(own.fwd), list(own.bwd)],
                                         "fwd": fwd_rows, "bwd": bwd_rows}
        del llr
        torch.cuda.empty_cache()


# ----- the runs, in turns ----------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a directory holding a copy of the package")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, run in this order")
    ap.add_argument("--kernels", choices=("all", "train", "train_sp", "decode", "sp_wide",
                                          "sp_shapes", "sp_train_shapes", "sampler"),
                    default="all")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", default="build/kernel_ab.json")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        print(json.dumps(worker(Path(args.worker), args.kernels,
                                os.path.dirname(args.out) if args.sass else "")))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    trees = {k: Path(v).resolve() for k, v in trees.items()}
    order = args.order.split(",") if args.order else list(trees)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs, failed = [], []
    for name in order:
        cmd = [sys.executable, __file__, "--worker", str(trees[name]),
               "--kernels", args.kernels, "--out", args.out] + (
                   ["--sass"] if args.sass else [])
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:  # report it, and go on with the other trees
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            failed.append(name)
            continue
        row = {"name": name, **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps({k: row.get(k) for k in ("name", "times_ms", "digests",
                                                   "grad_sums", "bwd_bit_identical",
                                                   "build_s", "run_point",
                                                   "base_step_trace_ms",
                                                   "base_step_syncs", "refused")}),
              flush=True)
        runs.append(row)
    summary = {}
    for name in dict.fromkeys(order):
        rows = [r["times_ms"] for r in runs if r["name"] == name]
        if rows:
            summary[name] = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
    result = {"card": smi, "order": order, "mean_ms": summary, "failed": failed,
              "runs": runs}
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": smi, "mean_ms": summary, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

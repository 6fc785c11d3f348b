#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`ldpc_error_floor_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc; it
builds the kernels from the repo's sources, so a fresh checkout suffices.
Phases, one JSON line each on stdout; any failed check raises and the run
exits non-zero:

1. device: `nvidia-smi` name and power limit, torch's device name;
2. build: nvcc of csrc/fused_nms_stats.cu (every mode of the decode kernel
   in one library), of csrc/fused_nms_train.cu (the training pair B4/B5;
   both include the one decode loop, csrc/fused_nms_kernel.cuh) and of
   csrc/awgn_llr.cu (the channel sampler S1), all started together, timed,
   with ptxas' register and shared-memory report;
3. each kernel against its plain PyTorch version on the card:
   - the channel sampler (S1, `sampler_vs_plain`) on the same noise: wman
     at 65536 and the 5G code with punctured and shortened rows at 1001
     words (not a multiple of 4), QMS on every grid (q_bit 6, 5, -5, 4,
     3), MS, MS_RAW and SP, the zero word, encoded codewords and their
     fold, one sigma and mixed lanes (`mix_sigma_lanes`), and `sample` /
     `sample_codewords(fold=True)` against the plain version on their own
     noise: 0 mismatches as int32 views, one launch each;
   on the same LLRs:
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
   - training forward (B4) against the plain forward at B=4096 (the plain
     autograd graph limits B): wman (3,0,3) QMS T=20 with the APP window
     t0=19 and t0=0, wman (3,3,3) T=30 t0=29 with base20's rows 0-19, MS
     (2,2,2), 'offset', per-edge (1,1,0), 5G systematic; QMS APPs bit-equal,
     MS within atol 1e-5;
   - training backward (B5) against autograd through the plain version on
     the same cases: each kind's gradient within rtol 1e-4 and atol
     1e-5 x max|g| (the worst error is printed), two launches bit-identical;
     three Adam steps through the kernels against three through the plain
     version, weights within atol 1e-5;
   - neural BP, the SP pair B4-SP/B5-SP, the same way at B=4096 (T=20):
     wman (3,0,3) with the window t0=19, (2,2,2) with UCN, per-edge (1,1,0),
     MacKay (3,3,3), 802.11n (3,0,3) (checks of 22 slots: B5-SP's and
     B4-SP's instances for checks past one chunk of 16); APPs within atol
     1e-3 / rtol 1e-4 (as B1-SP) and the last iteration's bit-equal to
     B1-SP's on the same LLRs; gradients and determinism as B5; three Adam
     steps on the SP base block;
   - at the training batch, 32768, on the base and the post block and the
     SP base block (in phase 7, from the timed launches): B4's streaming
     APPs bit-equal to the plain version's (SP: within atol 1e-3 / rtol
     1e-4) and to B4's no_grad launch (APPs alone, as the evaluator runs
     it), no word whose soft-FER term (the sign of its worst bit) differs,
     the soft-FER loss within rtol 1e-6, and B5's gradients within rtol 1e-4 and atol
     1e-5 x max|g| of the plain gradients, summed over chunks of 4096
     words, each scaled by 4096 / 32768, and bit-identical over two
     launches;
3b. the decoder's API (`decoder_api`) at the main path's width: base20 at
   4.0 dB on 65536 LLRs drawn from seed 0; `NMSDecoder.decode` with
   all-zero labels through B1 (stats), B2 (early stop) and B3 (deploy),
   every output bit-equal (signs of zero included) to the decode without
   labels, one launch each; labels with one bit set raise `ValueError`
   with the launch counts unchanged; a decoder on the card with
   `track_syndrome` raises; `apply(params, llr)` returns the APP stack
   (JAX's default 'apps') through one launch of B4 alone, its last
   iteration bit-equal to B1's APP;
3c. the executed-reference traces (`ref_traces`): for each of the six
   `tests/data/ref_traces/*.npz`, `collect='app_last'` on the card through
   B1 (B1-SP for mackay_sp), one launch, the APP on the target columns held
   to the trace's last iteration at rtol 1e-5 and atol 2e-4 (SP 2e-3), as
   `tests/test_torch_reference_trace.py`; the worst error per trace is
   printed;
4. end to end, each path driven through `FERSimulator.run_point` with the
   launch counts (the decode kernel's and the sampler's, one launch of
   each per batch) set to 0 just before and read just after (wman_N0576_R34_z24,
   QMS q_bit 5, sharing (3,3,3), 4.0 dB, seed 0, 2^20 frames in batches of
   65536, `inner_steps` K = 8: each host read one replay of a CUDA graph of
   8 batches; the launch counts are the batches'):
   - base20, fixed T=20: FER_genie in [1.5e-4, 2.7e-4] and exactly 211 genie
     errors; plain min-sum (all-ones weights) at least 2x worse, exactly
     846;
   - base20 with the genie early stop: FER_genie exactly 2.0122528e-4, the
     fixed-T run's;
   - boosted30 (composed from base20 at boundary 20, T=30) with the early
     stop: genie errors at most 0.8x base20's, exactly 121, and identical
     without it;
   - base20 with the syndrome stop: FER_last >= base20's FER_genie,
     FER_undetected <= FER_last, mean iterations in [3.05, 3.35] and
     3.18807 to five decimals;
   - belief propagation (SP, no weights, T=20): FER_genie at most plain
     min-sum's;
   - the deep error-floor anchor: base20 with the early stop at 5.5 dB,
     seed 0, over 2^25 frames, at K = 1 and at K = 8: 35 genie errors in
     both, consistent with the JAX package's 32 errors over 22,020,096
     frames (benchmarks/runs/boosted_wman_full/DEEP_FLOOR.json, "base",
     5.5 dB) under a two-sample conditional binomial test at p >= 0.01;
   - a point in the error floor: the bundled iter50 weights (sharing
     (3,3,3), T=50) with the early stop at 5.0 dB, seed 0, over 2^27
     frames at K = 8: its genie count consistent with JAX's 40 over
     185,466,880 frames (benchmarks/RESULTS.md, the iter50 table) under the
     same test;
5. harvest: `run_collection` with base20 and the early stop at 4.2 dB
   collects 256 words into a temporary Uncor file; the fixed-T kernel finds
   every one wrong at every iteration, boosted30 rescues at least 25%, and
   the file holds as many rows as words were returned; the harvester's
   frames and frames/s (`harvest_rate`), cold (a new harvester) and warm
   (the same one again), each finding run_collection's words, beside a
   cold and a warm run_point of the same path at 4.2 dB; then
   `classify_failures` (analyze-uncor) over those words: with boosted30 its
   `rescued` equals the count above, with base20 it is 0, one launch of
   the fixed-T kernel each;
6. training end to end through `run_training` (launch counts from the run):
   - base block: `base_config_wman` (sharing (3,0,3), T=20, soft FER,
     eta 0) at batch 32768, 20 steps per epoch, 2 epochs, learning rate
     1e-2, 65536 valid frames per SNR; the valid FER_last summed over the
     five SNRs falls from epoch 0 (all-ones weights) to epoch 2 by at
     least 5%; the weight and perf-log files appear;
   - post block: ~4096 words harvested at 4.2 dB with base20 and the early
     stop, split 2048/1024/1024, base20 written as the frozen prefix
     `{prefix}_Opt_Weight_End20.txt`; `post_config_wman` (sharing (3,3,3),
     [20, 30), sampling_type 1) at batch 512, 3 epochs; rows 0-19 of every
     kind bit-equal to base20 afterwards, rows 20-29 moved, the training
     loss falls;
   - neural BP base block: `base_config_wman` with decoding type 0 (SP),
     otherwise as the base block; the weight and perf-log files appear, the
     rows moved, and the valid FER_last sum at epoch 2 is at most 5% above
     epoch 0's (plain BP: neural BP gains little over BP on this code);
7. the host loop: one base20 early-stop batch run eagerly (K = 1, as the
   port ran every batch before it had the graph) and one replay of the
   graph of K = 1 and of K = 8 batches, each traced through
   `utils.profiling.trace` into `build/host_loop/` (and a warm run_point
   of 2^20 frames of each): the card's time per kernel, the idle gaps
   between its first and last activity, the host's time to issue the
   call, the time of a first read (with the capture) and of a second, and
   the device memory the two reads took at their peak (a trace in which
   the profiler recorded no activity of the card is taken again, at most
   three times in all, and the count is printed); then run_point
   frames/s, cold (a new simulator) and warm (the same point again), and
   the sampler's card ms per batch by kernel name (`awgn_llr`, `randn`,
   the sigma fill), and
   the kernel's share of a warm batch for K = 1 eager, K = 1 graph and
   K = 8 graph on base20 and boosted30 with the early stop, the syndrome
   stop, BP and the deep anchor (each point's counters equal in all six
   runs);
   timing with CUDA events at batch 65536 unless noted: each kernel and its
   plain version (S1 also with the fold, `randn` alone and a whole
   `sample`), the early stop at 4.0, 5.0 and 5.5 dB against the
   fixed-T kernel on the same LLRs with the distribution of iterations per
   tile of G words (mean, max, share that runs all T), SP at 16384 too,
   run_point frames/s, the syndrome stop's word-iterations and iterations
   per block and its bound at its own G and at G = 16, and each decode
   instance's launch shape, resident blocks per SM (B1-SP must hold two)
   and ptxas' registers, stack frame and spills (the SP instances' too);
   B4 and B5
   at batch 32768 on the base and post blocks against the plain version on
   the same inputs (in chunks of 4096), each one's achieved device-memory
   rate and multiple of its bound, one whole train step (sampling, B4,
   loss, B5, Adam) and trained codewords/s, the plain step at 4096; the
   same for B4-SP and B5-SP on the SP base block, with their launch
   shapes; ptxas' report of every training instance, and 0 stack bytes and
   0 spills in B4-SP's and B5-SP's instances on the main path (wman's
   checks fit one chunk);
8. the mesh (`parallel/mesh.py`), launch counts set to 0 just before each
   path and read just after:
   - an NCCL world of one (`data_mesh()`): base20 with the early stop and
     with the syndrome stop through `FERSimulator(mesh=...)` at 4.0 dB,
     seed 0, 2^20 frames at 65536, K = 8: exactly 211 genie errors and
     3.18807 mean iterations, 16 launches each; warm frames/s of the
     early-stop path with and without the mesh, in turns; a traced warm
     point (`build/host_loop/mesh_run_point/`): the all-reduce's time per
     host read, on the card and on the host;
   - the base block through `run_training(mesh=...)` (3 steps at 32768,
     one epoch): weights, losses and metrics bit-equal to the run without
     the mesh; the channel sampler at 32768 and 16384 words (what a rank
     of a world of two draws, against what it decodes);
   - two gloo ranks sharing the card (NCCL refuses two ranks on one
     device), each a process of this script (``--mesh-rank r port dir``)
     under a timeout of its own: base20's two points at the global batch,
     their pooled counters equal to both rank generators (`rank_generator`)
     run here at 32768; a harvest of 64 words at 4.2 dB whose
     ``uncor.txt.part{r}`` files hold exactly the rank generators' rows;
     one train step whose loss and weights agree with a world of one's
     within rtol 1e-5;
   - (iv) the launcher (`parallel/launch.py`), at each W of 1, 2 and 4 the
     host has cards for (the first W made visible): the CLI's `simulate
     --mesh` as a user runs it, W NCCL ranks, one per card: base20 with the
     early stop at 4.0 dB twice (2^20 frames at 65536, K = 8; a curve
     gives each point a generator and a capture of its own), with the
     syndrome stop, and the deep anchor twice; each first point's counters
     equal exactly the sums of the W rank generators run here at 65536 / W
     from the generator the CLI's curve draws for it (at W = 1 also the
     same command in this process and in a process of its own without the
     mesh, whose time splits the launcher's cost from a process's); at W >
     1 also the deep anchor at 65536 words a rank (2^25 frames a rank);
     every deep count is held to JAX's under the binomial test; `train --mesh
     --mesh-devices W` on the base block, 2 epochs of 100 steps at 32768:
     its files at W = 1 byte-equal to `run_training` here (the running
     times aside), its step ms from the perf log, beside the sampler at
     32768 / W; W ranks of this script (``--nccl-rank r W port dir``) on
     the W cards: base20's two paths at seed 0 equal to the rank
     generators' sums (at W = 1: 211 genie errors and 3.18807 mean
     iterations), 16 launches of B2 or B3 and of S1 each, warm frames/s
     (the point again on the same generator) in total and per card, and
     the all-reduce's ms per host read in a traced warm point; each
     command's seconds from spawn to exit.  ``chip_smoke.py --launcher``
     runs the device and build phases and this sub-phase alone (the call
     on several cards);
9. the `kernels` line (nine entries), then the card's nvidia-smi line,
   then the result.

It imports neither JAX nor the JAX package. It exits 2, printing nothing
on stdout, without a card or without `ldpc_error_floor_tpu_torch/` beside
it (the script alone in a directory of its own).
"""

from __future__ import annotations

import json
import os
import re
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
TRAIN_B = 32768          # the base block's training batch
TRAIN_CHECK_B = 4096     # kernel-vs-plain checks of B4/B5 (autograd memory)
FER_DROP = 0.05          # the base block's valid FER_last must fall by this
PR1_FER_GENIE = 211 / 2 ** 20  # 2.0122528e-4: base20, fixed T, seed 0
DEEP_SNR, DEEP_FRAMES = 5.5, 2 ** 25  # the deep error-floor anchor
JAX_DEEP = (32, 22_020_096)  # JAX: base20 genie errors, frames at 5.5 dB
DEEP_ERRORS = 35             # the port's deep anchor, seed 0
K_MAIN = 8                   # batches per host read (one CUDA graph replay)
PLAIN_MS_ERRORS, BOOST_ERRORS = 846, 121  # plain min-sum, boosted30: seed 0
SYNDROME_MEAN_ITERS = 3.18807  # base20's syndrome stop, seed 0
ITER50_SNR, ITER50_FRAMES = 5.0, 2 ** 27  # the iter50 weights in the error floor
JAX_ITER50 = (40, 185_466_880)  # JAX: iter50 genie errors, frames at 5.0 dB
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_SIMPLE_OPS_PER_S = 33.5e12  # 67 TFLOP/s f32 counts an FMA as 2; adds,
#                                  compares and selects issue at half that
SFU_OPS_PER_S = 132 * 16 * 1.98e9  # 132 SMs x 16 special-function results
#                                    per clock (compute capability 9.0) x boost clock
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9  # 132 SMs x 128 B/clk x boost clock
MESH_RANKS = 2            # the mesh phase's gloo ranks sharing the card
MESH_TIMEOUT_S = 300      # each rank process, and each collective of theirs
MESH_WORDS = 64           # the two ranks' harvest, words in all
LAUNCH_WORLDS = (1, 2, 4)  # the launcher's worlds, as far as the host has cards
LAUNCH_TIMEOUT_S = 300    # each command through the launcher, and each NCCL rank
TRAIN_STEPS = 100         # steps of an epoch of the launcher's train command
TRACE_ATTEMPTS = 3        # a trace with no activity of the card is taken again
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"  # punctured and shortened rows
SAMPLER_ODD_B = 1001      # the sampler's ragged batch (B % 4 != 0)
SAMPLER_TYPES = ((2, 6), (2, 5), (2, -5), (2, 4), (2, 3), (1, 5), (3, 5), (0, 5))
#                          (decoding type, q_bit): QMS on every grid, MS, MS_RAW, SP


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


def sampler_bound(R: int, B: int, quantize: bool, fold: bool = False) -> dict:
    """Least time for S1 on R x B words: device bytes (the noise, the
    sigmas and, on the fold path, the codeword bits read once; the LLRs
    written once) over 3.35 TB/s, and its operations over the simple f32
    rate: per word the multiply and add of y, 2y, sigma^2, the divide, the
    two blends (subtract, two multiplies, add each), 12; 5 more under QMS
    (divide, round, multiply, min, max); 5 more on the fold path (2b - 1,
    then 1 - 2b and its multiply)."""
    nbytes = 4 * R * B * (3 if fold else 2) + 4 * B
    ops = R * B * (12 + (5 if quantize else 0) + (5 if fold else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_SIMPLE_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def train_bound(kern, B: int, backward: bool) -> dict:
    """Least time for B4 (forward) or B5 (backward) of the FusedTrainKernel
    `kern` on B words: device bytes over 3.35 TB/s against simple f32
    operations over 33.5 T/s (SP: or its tanh and atanh over the
    special-function units' rate, whichever is longer).  A multiply that
    feeds an add counts once (one FMA issues at that rate).  Bytes, each
    once: B4 reads the LLRs and weights and writes the pre-clip V->C stream
    [T, E*z], the check residuals [T, R*M*z] (R = `kern.cres_rows`) and the
    APP window [T-t0, N*z]; B5 reads the LLRs, weights, both streams, the
    pre-clip APPs and their cotangent, and writes the gradients.
    Operations per iteration and word: B4 as B1 (16 per edge slot, 17 with
    UCN; 16 per lifted check; 10 per bit).  B5, what the function needs,
    each message derived once from its pre-clip value:
      per edge slot, 35 (36 with UCN):
        the message: quantize (divide, round, multiply, min, max) 5, zero
          nudge (compare, select) 2, |x| with the sentinel (abs, compare,
          select) 3;
        the slot's sign (compare, select) 2;
        min1 or not (compare) and the extrinsic magnitude (select) 2;
        the output's sign (times the check's negated product) 1;
        the cotangent through the weighting chain: times that sign, the
          ReLU/clip mask (select), times the weight 3;
        the weight gradient: times the magnitude into the edge's sum (FMA) 1
          (with UCN one more select, CN or UCN sum);
        the tie bookkeeping: into the min1 or the other sum (select, add),
          the min1 count (add), the min2 count (compare, add) 5;
        the tie-splitting share: own cotangent out of the min1 sum, times
          the per-check reciprocal plus the other sum's share (FMA), two
          selects among the cases 4;
        |x|'s sign (select) and the clip mask of the pre-clip value (abs,
          compare, select) 4;
        the V->C transpose: into the bit's sum, own share out, plus the
          APP cotangent 3;
      per lifted check, 28 (30 with UCN): for each of the two extrinsic
        magnitudes the nudge (abs, compare, subtract, select) 4, the weight
        1, the ReLU/clip mask (two compares, and) 3, its sign (compare,
        select) 2; the sentinel pads in both tie counts (compare, add each)
        4, the reciprocals (max, two divides) 3, the several-minima flag 1;
        with UCN the weight blend (subtract, FMA) 2;
      per bit, 8: llr times the VN weight, the quantizer's clip mask (abs,
        compare, select), times llr into the sum (FMA) 5; the APP's clip
        mask (abs, compare, select) 3.
    B4-SP as B1-SP (16 per edge slot, 17 with UCN; 16 per lifted check; 10
    per bit) plus a tanh and an atanh per edge slot.  B5-SP, each message
    derived once, its tanh and the product's atanh once more:
      per edge slot, 45 (46 with UCN) and the two transcendentals:
        the message's clip (min, max) 2 and the clip mask of the pre-clip
          value (abs, compare, select) 3;
        the tanh argument (multiply) 1 and the zero fix (compare, select) 2;
        the prefix and suffix products and their product p 3;
        the product's clip (min, max) 2, times -2 1, |out| 1;
        the weighting chain: times the weight 1, the ReLU/clip mask (two
          compares, and) 3, the weight gradient (the cotangent times out,
          sign(out)*|out|, into the edge's sum: FMA) 1, the cotangent times
          the weight 1, and |out|'s gradient: sign(out) * sign(out) is
          [out != 0] (compare, select) 2 (with UCN one more select, CN or
          UCN sum);
        atanh's derivative: 1 - pc^2 (FMA), -2 over, times 3;
        the product clip's gradient (1 inside, 1/2 at a bound: |p|, two
          compares, two selects) and its product with the cotangent 6;
        gF and gB (two multiplies) 2;
        the suffix and the prefix recurrences' reverses, each a running sum
          (FMA) 2, and the slot's tanh cotangent, one share (multiply) plus
          the other (FMA) 2;
        tanh's derivative: 1 - t^2 (FMA), times -1/2, times 3; the clip
          mask's select 1;
        the V->C transpose: into the bit's sum, own share out, plus the APP
          cotangent 3;
      per lifted check, 2 with UCN (the weight blend), else 0;
      per bit, 4: times llr into the sum (FMA) 1, the APP's clip mask 3
        (SP has no quantizer)."""
    graph, spec = kern.graph, kern.spec
    code = graph.code
    Ez, Mz, Nz = graph.E * code.z, code.M * code.z, code.N * code.z
    T, t0, R = spec.n_iters, kern.t0, kern.cres_rows
    ucn = spec.ucn_enabled
    sp = kern.cfg.decoding_type == 0
    dims = sum(spec.dim(k, graph) for k in ("cn", "ucn", "vn"))
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
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_SIMPLE_OPS_PER_S * 1e3
    out = {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms}
    if sp:  # a tanh and an atanh per edge slot, forward and again backward
        out["transcendentals"] = B * T * 2 * Ez
        out["transcendental_ms"] = out["transcendentals"] / SFU_OPS_PER_S * 1e3
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


def tile_iters(err, G: int) -> dict:
    """Iterations each tile of G words ran under the early stop (from its
    flags [T, B], the last tile ragged): mean, max and the share of tiles
    that ran all T."""
    import torch
    T, B = err.shape
    still = torch.cumprod(err.to(torch.int32), dim=0).bool()
    still = torch.cat([still, still.new_zeros((T, -B % G))], dim=1)
    iters = (1 + still.view(T, -1, G).any(dim=2)[:-1].sum(dim=0)).float()
    return {"tiles": iters.numel(), "mean": float(iters.mean()), "max": int(iters.max()),
            "share_all_T": float((iters == T).float().mean())}


def binomial_two_sample_p(k1: int, n1: int, k2: int, n2: int) -> float:
    """Two-sided p-value of equal rates for k1 events in n1 trials against
    k2 in n2, conditional on k1 + k2: k1 ~ Binomial(k1 + k2, n1 / (n1 + n2))
    under the null; the p-value sums the outcomes no likelier than k1."""
    import math
    k, q = k1 + k2, n1 / (n1 + n2)

    def logpmf(i):
        return (math.lgamma(k + 1) - math.lgamma(i + 1) - math.lgamma(k - i + 1)
                + i * math.log(q) + (k - i) * math.log1p(-q))
    obs = logpmf(k1)
    return min(1.0, sum(math.exp(logpmf(i)) for i in range(k + 1)
                        if logpmf(i) <= obs + 1e-9))


def deploy_word_iters(iters, G: int) -> int:
    """(word, iteration) pairs the syndrome-stop kernel ran: a block of G
    words runs until its last word's syndrome holds, or T."""
    return int(iters.view(-1, G).amax(dim=1).sum()) * G


def deploy_block_iters(iters, G: int, T: int) -> dict:
    """Iterations each block of G words ran under the syndrome stop (its
    slowest word's): mean, max and the share of blocks that ran all T."""
    blk = iters.view(-1, G).amax(dim=1).float()
    return {"blocks": blk.numel(), "mean": float(blk.mean()), "max": int(blk.max()),
            "share_all_T": float((blk == T).float().mean())}


def trace_summary(trace_path: str, span: str) -> dict:
    """From a Chrome trace of `utils.profiling.trace`: the card's time per
    kernel name and in copies and fills (ms), its busy time (the union of
    its activities), the idle gaps between its first and last activity, and
    the host's time inside the `annotate`d `span` with the CUDA runtime
    calls made there (count and ms)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels, other, spans, iv = {}, 0.0, [], []
    runtime_n, runtime_ms = 0, 0.0
    for e in events:
        cat, dur = e.get("cat"), e.get("dur", 0) / 1e3
        if cat == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + dur
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other += dur
        elif cat == "user_annotation" and e.get("name") == span:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            continue
        else:
            continue
        iv.append((e["ts"], e["ts"] + e["dur"]))
    for e in events:  # the runtime calls inside the span
        if e.get("cat") == "cuda_runtime" and any(a <= e["ts"] < b for a, b in spans):
            runtime_n += 1
            runtime_ms += e.get("dur", 0) / 1e3
    iv.sort()
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span_ms = (iv[-1][1] - iv[0][0]) / 1e3 if iv else 0.0
    return {"kernel_ms": kernels, "copy_fill_ms": other, "device_busy_ms": busy / 1e3,
            "device_span_ms": span_ms, "idle_gaps_ms": span_ms - busy / 1e3,
            "host_issue_ms": sum(b - a for a, b in spans) / 1e3,
            "runtime_calls": runtime_n, "runtime_ms": runtime_ms}


def build_kernels():
    """nvcc of the three kernel sources, one process each, all started
    together: the seconds it took, ptxas' report and the compiler's log per
    source."""
    from concurrent.futures import ThreadPoolExecutor

    from ldpc_error_floor_tpu_torch.ops import awgn_llr, fused_decoder, fused_train
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
        builds = [pool.submit(fn) for fn in (fused_decoder.load_library,
                                             fused_train.load_library,
                                             awgn_llr.load_library)]
        logs = {src: b.result()[1] for src, b in
                zip(("fused_nms_stats.cu", "fused_nms_train.cu", "awgn_llr.cu"), builds)}
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
             for src, log in logs.items()}
    return time.perf_counter() - t0, ptxas, logs


def collective_trace(tdir: str, n_reads: int) -> dict:
    """The collectives in a trace of `traced` (events whose name says NCCL
    or all-reduce), by category and name: count, ms and ms per host read;
    fails without one per read."""
    with open(os.path.join(tdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    coll = {}
    for e in events:
        name = str(e.get("name", ""))
        if "nccl" in name.lower() or "all_reduce" in name.lower() or "allreduce" in name.lower():
            key = f"{e.get('cat')}:{name}"
            n, ms = coll.get(key, (0, 0.0))
            coll[key] = (n + 1, ms + e.get("dur", 0) / 1e3)
    out = {k: {"count": n, "ms": ms, "ms_per_read": ms / n_reads}
           for k, (n, ms) in coll.items()}
    check(any(v["count"] >= n_reads for v in out.values()),
          f"no all-reduce per host read in the trace: {list(coll)}")
    return out


def sampler_ms_per_batch(summary: dict, batches: int) -> dict:
    """The channel sampler's card ms per batch in a `trace_summary`, by
    kernel name: the `awgn_llr` kernel, `randn` (PyTorch's normal
    distribution kernel) and the sigma fill, and their total."""
    by = {"awgn_llr": "awgn_llr", "randn": "normal", "fill": "FillFunctor<float>"}
    out = {k: sum(ms for kn, ms in summary["kernel_ms"].items() if pat in kn) / batches
           for k, pat in by.items()}
    out["total"] = sum(out.values())
    return out


def traced(run, tdir: str, span: str) -> dict:
    """Run `run()` inside an `annotate`d `span` under `utils.profiling.trace`
    into `tdir`, then the card's summary of it (`trace_summary`).  A trace
    in which the profiler recorded no activity of the card at all (no
    kernel, copy or fill; it happened once to a one-replay trace on the
    H100, whose launch counts and errors showed the kernels ran) is taken
    again, at most TRACE_ATTEMPTS times in all; `trace_attempts` says how
    many it took, and the last trace is the one kept and summed."""
    import torch

    from ldpc_error_floor_tpu_torch.utils import annotate, trace
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with trace(tdir):
            with annotate(span):
                run()
            torch.cuda.synchronize()
        out = trace_summary(os.path.join(tdir, "trace.json"), span)
        if out["device_busy_ms"] > 0.0:
            break
        print(f"chip_smoke: the trace in {tdir} holds no activity of the card "
              f"(attempt {attempt})", file=sys.stderr)
    return {**out, "trace_attempts": attempt}


def ptxas_by_instance(log: str, kern_name) -> dict:
    """ptxas' registers, stack frame and spill bytes of each kernel instance
    in a library's build log (`-Xptxas -v`), by kernel name: the decode
    library's `fused_nms_kernel<mode, sp, code, chunks>` (the min-sum ones
    marked [code] or [float]), the training library's
    `fused_nms_kernel<kTrain, sp, false, chunks>` (B4, B4-SP) and
    `train_bwd_kernel<sp, chunks>` (B5, B5-SP); the SP training instances
    for checks of more than one chunk of 16 slots marked [wide]."""
    out, entry, mangled, props = {}, None, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry, mangled, props = None, m.group(1), None
            k = re.search(r"fused_nms_kernelILi(\d)ELb([01])ELb([01])ELi(\d+)E", mangled)
            b = re.search(r"train_bwd_kernelILb([01])ELi(\d+)E", mangled)
            if k:  # B4-SP: for checks of one chunk, and [wide] for up to 64 slots
                mode, sp, code, chunks = (int(x) for x in k.groups())
                sfx = "_sp" if sp else ""
                entry = ("fused_nms_train_fwd" + sfx + ("[wide]" if sp and chunks > 1 else "")
                         if mode == 3 else kern_name(mode, bool(sp))) + (
                    "" if sp or mode == 3 else "[code]" if code else "[float]")
            elif b:  # B5-SP: for checks of one chunk, and [wide] for up to 64 slots
                entry = "fused_nms_train_bwd" + ("_sp" if b.group(1) == "1" else "") + (
                    "[wide]" if int(b.group(2)) > 1 else "")
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and entry and props == mangled:
            out.setdefault(entry, {}).update(zip(("stack", "spill_stores", "spill_loads"),
                                                 (int(x) for x in m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def point_counts(pt, nbits: int) -> dict:
    """A point's integer counters, from its rates."""
    out = {"frames": pt.frames, "bit_errors": round(pt.ber_last * pt.frames * nbits),
           "frame_errors": round(pt.fer_last * pt.frames)}
    if pt.avg_iters is None:
        out["genie_errors"] = round(pt.fer_genie * pt.frames)
    else:
        out["undetected"] = round(pt.fer_undetected * pt.frames)
        out["iters_sum"] = round(pt.avg_iters * pt.frames)
    return out


def mesh_paths(dev, mesh=None, batch=MAIN_B):
    """The mesh phase's two Monte-Carlo paths on wman at `batch`, K = 8:
    base20 with the genie early stop and with the syndrome stop; ((label,
    simulator), ...) and base20's parameters."""
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder, WeightSpec,
                                                   load_params)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 3, 3), n_iters=T_MAIN)
    params = load_params(spec, graph, f"{WMAN}_base20", device=dev)
    sims = tuple(
        (label, FERSimulator(NMSDecoder(code, cfg, spec, graph=graph, device=dev),
                             AWGNChannel(code, device=dev), batch=batch, stop=stop,
                             inner_steps=K_MAIN, mesh=mesh))
        for label, cfg, stop in (("early_stop", DecoderConfig(early_stop=True), "genie"),
                                 ("syndrome", DecoderConfig(), "syndrome")))
    return sims, params


def mesh_train_once(dev, mesh=None):
    """One Adam step (learning rate 1e-2) on the base block ((3,0,3), T=20,
    soft FER, eta 0) from all-ones weights, on this rank's lanes of a batch
    of TRAIN_B words at the base config's five SNRs drawn from seed 3 (the
    whole batch without a mesh); (loss, weights on the host, launches)."""
    import torch
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.channel.awgn import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder, WeightSpec,
                                                   init_weights)
    from ldpc_error_floor_tpu_torch.parallel import batch_constraint
    from ldpc_error_floor_tpu_torch.pipelines import base_config_wman
    from ldpc_error_floor_tpu_torch.training import make_optimizer, make_train_step
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=T_MAIN)
    dec = NMSDecoder(code, DecoderConfig(app_t0=T_MAIN - 1), spec, graph=graph, device=dev)
    sig = torch.as_tensor(mix_sigma_lanes(code.snr_sigmas(base_config_wman().snrs), TRAIN_B),
                          device=dev)
    llr = AWGNChannel(code, device=dev).sample(
        torch.Generator(device=dev).manual_seed(3), sig)
    shard = batch_constraint(mesh)
    params = init_weights(spec, graph, device=dev)
    opt = make_optimizer(params, 1e-2)
    step = make_train_step(dec, spec, 2, 0, T_MAIN, static_etha=0.0, mesh=mesh)
    loss = float(step(params, opt, shard(llr), shard(torch.zeros_like(llr)), 0.0))
    return loss, {k: None if v is None else v.detach().cpu() for k, v in params.items()}, \
        dict(dec.train_kernel.launches)


def mesh_worker(rank: int, port: str, out_dir: str) -> int:
    """Rank `rank` of the mesh phase's MESH_RANKS gloo ranks sharing the
    card (NCCL refuses two ranks on one device): base20's early-stop and
    syndrome-stop points at 4.0 dB over 2^20 frames at the global batch, a
    harvest of MESH_WORDS words at 4.2 dB into ``uncor.txt.part{rank}`` and
    one train step, through the mesh; results into `out_dir`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ldpc_error_floor_tpu_torch.parallel import data_mesh, initialize_distributed
    from ldpc_error_floor_tpu_torch.sim import UncorHarvester
    initialize_distributed(f"127.0.0.1:{port}", MESH_RANKS, rank, device="cuda",
                           backend="gloo", timeout_s=MESH_TIMEOUT_S)
    mesh = data_mesh(MESH_RANKS, device="cuda")
    sims, base20 = mesh_paths(mesh.device, mesh)
    out = {"rank": mesh.rank, "world": mesh.world, "backend": dist.get_backend()}
    for label, sim in sims:
        pt = sim.run_point(base20, 4.0, torch.Generator(device=mesh.device).manual_seed(0),
                           max_frames=MAX_FRAMES, target_frame_errors=None)
        out[label] = point_counts(pt, sim.decoder.target * sim.decoder.z)
        out[label + "_launches"] = dict(sim.decoder.kernel.launches)
        out[label + "_frames_per_sec"] = pt.frames_per_sec  # cold, the ranks in turn
    sim = sims[0][1]  # harvest with the early stop, as run_collection does
    harv = UncorHarvester(sim.decoder, sim.channel, batch=MAIN_B, mesh=mesh)
    words = harv.collect(base20, 4.2, torch.Generator(device=mesh.device).manual_seed(0),
                         target_words=MESH_WORDS, out_file=os.path.join(out_dir, "uncor.txt"))
    out["harvest"] = {"frames": harv.frames, "hits": harv.hits, "words": int(words.shape[0])}
    loss, weights, out["train_launches"] = mesh_train_once(mesh.device, mesh)
    out["loss"] = loss
    np.savez(os.path.join(out_dir, f"weights_{rank}.npz"),
             **{k: v.numpy() for k, v in weights.items() if v is not None})
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def visible_env(world: int) -> dict:
    """This process's environment with only the first `world` of its cards
    visible."""
    import torch
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = vis.split(",") if vis else [str(i) for i in range(torch.cuda.device_count())]
    return dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(ids[:world]))


def run_cli(argv, world: int):
    """``python -m ldpc_error_floor_tpu_torch.cli *argv`` as a user runs it,
    on the first `world` cards, in a session of its own (killed whole, the
    launcher's ranks with it, past LAUNCH_TIMEOUT_S); (its standard output,
    seconds from spawn to exit).  Fails unless it exits 0."""
    import contextlib
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "ldpc_error_floor_tpu_torch.cli", *argv],
                            cwd=REPO, env=visible_env(world), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except BaseException:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"`{argv[0]} --mesh` at W = {world} exited "
                                f"{proc.returncode}:\n{err[-3000:]}")
    return out, seconds


def nccl_worker(rank: int, world: int, port: str, out_dir: str) -> int:
    """Rank `rank` of the launcher sub-phase's `world` NCCL ranks, one per
    card: base20 with the early stop and with the syndrome stop at 4.0 dB,
    seed 0, over 2^20 frames at the global batch (launch counts set to 0
    just before each, read just after), then the early stop warm, and warm
    in a trace (the all-reduce per host read); results into `out_dir`."""
    import torch
    import torch.distributed as dist

    from ldpc_error_floor_tpu_torch.parallel import data_mesh, initialize_distributed
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cuda",
                           timeout_s=LAUNCH_TIMEOUT_S)
    mesh = data_mesh(world, device="cuda")
    sims, base20 = mesh_paths(mesh.device, mesh)
    gen = torch.Generator(device=mesh.device)
    out = {"rank": mesh.rank, "world": mesh.world, "backend": dist.get_backend(),
           "device": str(mesh.device)}
    for label, sim in sims:
        sim.decoder.kernel.launches.clear()
        sim.channel.launches.clear()
        pt = sim.run_point(base20, 4.0, gen.manual_seed(0), max_frames=MAX_FRAMES,
                           target_frame_errors=None)
        out[label] = point_counts(pt, sim.decoder.target * sim.decoder.z)
        out[label + "_launches"] = {**sim.decoder.kernel.launches, **sim.channel.launches}

    def point():
        return sims[0][1].run_point(base20, 4.0, gen.manual_seed(0), max_frames=MAX_FRAMES,
                                    target_frame_errors=None)

    out["warm_frames_per_sec"] = point().frames_per_sec
    tdir = os.path.join(out_dir, f"trace_{rank}")
    out["run_point_trace"] = traced(point, tdir, "run_point")
    out["all_reduce_trace"] = collective_trace(tdir, MAX_FRAMES // (MAIN_B * K_MAIN))
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_nccl_ranks(world: int, out_dir: str) -> list:
    """`world` ranks of this script (``--nccl-rank``), one on each of the
    first `world` cards, each under LAUNCH_TIMEOUT_S; their results."""
    import socket
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    logs = [open(os.path.join(out_dir, f"rank_{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--nccl-rank", str(r),
                               str(world), port, out_dir], cwd=REPO, env=visible_env(world),
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for proc in procs:
            proc.wait(timeout=LAUNCH_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = []
    for r, (proc, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        check(proc.returncode == 0, f"NCCL rank {r} of {world} exited {proc.returncode}:\n"
                                    f"{text[-3000:]}")
        with open(os.path.join(out_dir, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def run_files(out_dir: str) -> dict:
    """A training run's files, as lines, the perf log's running times aside."""
    files = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            files[name] = [ln for ln in f.read().splitlines()
                           if not ln.startswith("Running time")]
    return files


def last_epoch_train_s(out_dir: str) -> float:
    """The training seconds of the last epoch in a run's perf log."""
    (log,) = [n for n in os.listdir(out_dir) if n.endswith("_Performance.txt")]
    with open(os.path.join(out_dir, log)) as f:
        times = re.findall(r"Running time \(Train/Valid/Test\): ([0-9.]+)/", f.read())
    return float(times[-1])


def launcher_phase(dev) -> dict:
    """Sub-phase (iv) of the mesh: the CLI's `--mesh` through the launcher at
    each W of LAUNCH_WORLDS the host has cards for (the module's docstring
    says what it checks); its row."""
    import contextlib
    import dataclasses
    import io
    from types import SimpleNamespace

    import numpy as np
    import torch

    from ldpc_error_floor_tpu_torch import cli
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.channel.awgn import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.codes import get_code
    from ldpc_error_floor_tpu_torch.io.weight_files import read_weight_file
    from ldpc_error_floor_tpu_torch.ops import awgn_llr
    from ldpc_error_floor_tpu_torch.parallel import DataMesh, rank_generator
    from ldpc_error_floor_tpu_torch.pipelines import base_config_wman, run_training
    cards = torch.cuda.device_count()
    worlds = [w for w in LAUNCH_WORLDS if w <= cards]
    wman = get_code(WMAN)
    sim_argv = ["simulate", "--code", WMAN, "--weights", f"{WMAN}_base20", "--iters",
                str(T_MAIN), "--inner-steps", str(K_MAIN), "--target-errors", str(2 ** 62)]

    def command(label, W):
        """(flags, SNR, frames a point, points, global batch) of a command at
        W ranks; 'deep_per_card' gives each rank the batch one card decodes
        alone (and frames in proportion)."""
        return {"early_stop": (["--early-stop"], 4.0, MAX_FRAMES, 2, MAIN_B),
                "syndrome": (["--stop", "syndrome"], 4.0, MAX_FRAMES, 1, MAIN_B),
                "deep": (["--early-stop"], DEEP_SNR, DEEP_FRAMES, 2, MAIN_B),
                "deep_per_card": (["--early-stop"], DEEP_SNR, DEEP_FRAMES * W, 2,
                                  MAIN_B * W)}[label]

    def argv_of(label, W, mesh=True):
        flags, snr, frames, n, batch = command(label, W)
        return (sim_argv + flags + ["--snrs", *[str(snr)] * n, "--max-frames", str(frames),
                                    "--batch", str(batch)] + ["--mesh"] * mesh)

    paths, base20 = mesh_paths(dev)
    sims_at = {MAIN_B: dict(paths)}  # this process's two paths by batch

    def rank_sum(label, W, seed):
        """The counters of the W rank generators of `seed`, each at its
        share of the batch and the frames, summed (in this process)."""
        _, snr, frames, _, batch = command(label, W)
        if batch // W not in sims_at:
            sims_at[batch // W] = dict(mesh_paths(dev, batch=batch // W)[0])
        sim = sims_at[batch // W]["syndrome" if label == "syndrome" else "early_stop"]
        g0, want = torch.Generator(device=dev), {}
        for r in range(W):
            g = rank_generator(g0.manual_seed(seed), DataMesh(r, W, dev))
            p = sim.run_point(base20, snr, g, max_frames=frames // W, target_frame_errors=None)
            for k, v in point_counts(p, wman.n_full).items():
                want[k] = want.get(k, 0) + v
        return want

    # the CLI's curve seeds its first point from one draw of --seed's
    # generator (`run_curve`, as JAX splits the key), not with --seed itself
    curve_seed = int(torch.randint(0, 2 ** 62, (1,), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0)))
    # the early-stop command in this process without the mesh: what a
    # process of its own adds
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv_of("early_stop", 1, mesh=False)) == 0, "in-process simulate")
    in_process = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    row = {"cards": cards, "world": worlds, "in_process_s": time.perf_counter() - t0,
           "in_process_frames_per_sec": [p["frames_per_sec"] for p in in_process],
           "in_process_counters": point_counts(SimpleNamespace(**in_process[0]), wman.n_full)}
    # the global draw: a rank samples the whole batch to decode 1 / W of it
    sig = torch.as_tensor(mix_sigma_lanes(wman.snr_sigmas(base_config_wman().snrs), TRAIN_B),
                          device=dev)
    ch, g_s = AWGNChannel(wman, device=dev), torch.Generator(device=dev).manual_seed(0)
    sample_ms = {w: time_ms(lambda: ch.sample(g_s, sig[:TRAIN_B // w]), reps=20)
                 for w in LAUNCH_WORLDS}
    row["train_sample_ms"] = {f"B{TRAIN_B // w}": ms for w, ms in sample_ms.items()}
    train_cfg = dataclasses.replace(base_config_wman(), batch_size=TRAIN_B,
                                    training_num=TRAIN_STEPS * TRAIN_B, epochs=2,
                                    valid_num=TRAIN_B, learn_rate_start=1e-2, seed=0)
    by_world = row["by_world"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        here = dataclasses.replace(train_cfg, out_dir=os.path.join(tmp, "train_here"))
        ref = run_training(here, verbose=False, device=dev)
        row["train_here_step_ms"] = last_epoch_train_s(here.out_dir) / TRAIN_STEPS * 1e3
        ref_files = run_files(here.out_dir)
        ref_weights = read_weight_file(os.path.join(
            here.out_dir, f"{here.out_prefix}_Weight_End{here.iters_max}.txt"))[1]
        for W in worlds:
            res = by_world[W] = {"spawn_to_exit_s": {}}
            labels = ["early_stop", "syndrome", "deep"] + ["deep_per_card"] * (W > 1)
            for label in labels:
                out, res["spawn_to_exit_s"][label] = run_cli(argv_of(label, W), W)
                pts = [json.loads(ln) for ln in out.splitlines()]
                _, _, frames, n, batch = command(label, W)
                check(len(pts) == n and all(p["frames"] == frames for p in pts),
                      f"{label} at W = {W}: {out[-2000:]}")
                got = point_counts(SimpleNamespace(**pts[0]), wman.n_full)
                want = rank_sum(label, W, curve_seed)
                res[label] = {"batch": batch, "counters": got, "rank_sum": want,
                              "frames_per_sec": [p["frames_per_sec"] for p in pts]}
                check(got == want, f"{label} at W = {W}: {got} against the per-rank sum {want}")
                if label.startswith("deep"):
                    k = got["genie_errors"]
                    res[label]["p_vs_jax"] = binomial_two_sample_p(k, frames, *JAX_DEEP)
                    check(res[label]["p_vs_jax"] >= 0.01,
                          f"{label} at W = {W}: {k} genie errors over {frames} frames "
                          f"against JAX's {JAX_DEEP}")
            if W == 1:  # the same command in a process of its own, no launcher
                out, res["process_s"] = run_cli(argv_of("early_stop", 1, mesh=False), W)
                alone = point_counts(SimpleNamespace(**json.loads(out.splitlines()[0])),
                                     wman.n_full)
                check(res["early_stop"]["counters"] == alone == row["in_process_counters"],
                      f"launcher W = 1: {res['early_stop']['counters']} against {alone} in "
                      f"a process and {row['in_process_counters']} in this one")
                res["launcher_overhead_s"] = res["spawn_to_exit_s"]["early_stop"] - \
                    res["process_s"]
            # the base block through `train --mesh --mesh-devices W`
            cfg = dataclasses.replace(train_cfg, out_dir=os.path.join(tmp, f"train_W{W}"))
            cfg_path = cfg.out_dir + ".json"
            cfg.to_json(cfg_path)
            out, res["spawn_to_exit_s"]["train"] = run_cli(
                ["train", "--config", cfg_path, "--mesh", "--mesh-devices", str(W)], W)
            check(out.splitlines()[-1].startswith("done; best metric"), f"train: {out[-2000:]}")
            step_ms = last_epoch_train_s(cfg.out_dir) / TRAIN_STEPS * 1e3
            weights = read_weight_file(os.path.join(
                cfg.out_dir, f"{cfg.out_prefix}_Weight_End{cfg.iters_max}.txt"))[1]
            diff = max(float(np.max(np.abs(np.asarray(weights[k]) - np.asarray(v))
                                    / np.maximum(np.abs(np.asarray(v)), 1e-30)))
                       for k, v in ref_weights.items() if v is not None)
            extra = sample_ms[1] - sample_ms[W]
            res["train"] = {"step_ms": step_ms, "weights_max_rel_diff_vs_here": diff,
                            "global_draw_extra_ms": extra,
                            "global_draw_share": extra / step_ms}
            check(all(np.all(np.isfinite(np.asarray(v))) for v in weights.values()
                      if v is not None), f"train at W = {W}: weights not finite")
            if W == 1:
                check(run_files(cfg.out_dir) == ref_files,
                      "train through the launcher at W = 1: files differ from run_training's")
            # W ranks of this script on the W cards: launches, the all-reduce
            ranks = run_nccl_ranks(W, os.path.join(tmp, f"nccl_W{W}"))
            n_batches = MAX_FRAMES // MAIN_B
            # warm: the same point again on one simulator and generator (a
            # curve of the CLI gives each point a generator and a capture)
            res["warm_frames_per_sec"] = ranks[0]["warm_frames_per_sec"]
            res["warm_frames_per_sec_per_card"] = ranks[0]["warm_frames_per_sec"] / W
            res["nccl_ranks"] = {
                "devices": [rk["device"] for rk in ranks],
                "launches": [{k: rk[k] for k in ("early_stop_launches", "syndrome_launches")}
                             for rk in ranks],
                "warm_frames_per_sec": [rk["warm_frames_per_sec"] for rk in ranks],
                "idle_gaps_ms": [rk["run_point_trace"]["idle_gaps_ms"] for rk in ranks]}
            res["all_reduce_ms_per_read"] = {
                key: [rk["all_reduce_trace"].get(key, {}).get("ms_per_read") for rk in ranks]
                for key in sorted({k for rk in ranks for k in rk["all_reduce_trace"]})}
            check(all(rk["world"] == W and rk["backend"] == "nccl" for rk in ranks)
                  and [rk["device"] for rk in ranks] == [f"cuda:{r}" for r in range(W)],
                  f"NCCL ranks at W = {W}: {[(rk['world'], rk['device']) for rk in ranks]}")
            for label, kname in (("early_stop", "fused_nms_early_stop"),
                                 ("syndrome", "fused_nms_deploy")):
                want = rank_sum(label, W, 0)
                res["nccl_ranks"][label] = want
                check(all(rk[label] == want for rk in ranks),
                      f"NCCL ranks at W = {W}, {label}: {[rk[label] for rk in ranks]} "
                      f"against the per-rank sum {want}")
                check(all(rk[label + "_launches"] == {kname: n_batches, awgn_llr.KERNEL: n_batches}
                          for rk in ranks),
                      f"NCCL ranks at W = {W}, {label}: launches "
                      f"{[rk[label + '_launches'] for rk in ranks]}")
            if W == 1:  # the anchors of seed 0
                check(ranks[0]["early_stop"]["genie_errors"] == round(PR1_FER_GENIE * MAX_FRAMES),
                      f"NCCL rank, W = 1: {ranks[0]['early_stop']}")
                iters = ranks[0]["syndrome"]["iters_sum"] / MAX_FRAMES
                check(round(iters, 5) == SYNDROME_MEAN_ITERS,
                      f"NCCL rank, W = 1: {iters} mean iterations")
    row["train_here_launches"] = ref.launches
    return row


def launcher_main() -> int:
    """``chip_smoke.py --launcher``: the device and build phases and the
    mesh's sub-phase (iv) alone, then the cards' line and the result."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    emit({"phase": "device", "nvidia_smi": smi, "cards": torch.cuda.device_count(),
          "torch_name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    build_s, ptxas, _ = build_kernels()
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    emit({"phase": "mesh_launcher", "card": smi, **launcher_phase(torch.device("cuda"))})
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "ldpc_error_floor_tpu_torch")):
        print(f"chip_smoke: no ldpc_error_floor_tpu_torch/ beside this script in {REPO}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank process of the mesh phase
        return mesh_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--nccl-rank"]:  # a rank process of the launcher sub-phase
        return nccl_worker(*map(int, sys.argv[2:4]), *sys.argv[4:6])
    if sys.argv[1:2] == ["--launcher"]:  # the launcher sub-phase alone
        return launcher_main()
    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.io import read_uncor_file
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec,
                                                   compose_boosted_params,
                                                   init_weights, load_params,
                                                   stack_weights)
    from ldpc_error_floor_tpu_torch.ops import awgn_llr, fused_train
    from ldpc_error_floor_tpu_torch.ops.fused_decoder import (DEPLOY, EARLY_STOP, FIXED,
                                                              FusedNMSKernel)
    from ldpc_error_floor_tpu_torch.ops.fused_decoder import kernel_name as kern_name
    from ldpc_error_floor_tpu_torch.pipelines import (ExperimentConfig,
                                                      run_collection)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator, classify_failures

    class EagerFERSimulator(FERSimulator):
        """The host loop as the port ran it before the CUDA graph: each
        chunk's steps issued from Python (the timing phase's K = 1 eager)."""

        def _chunk(self, params, generator, sigma):
            with torch.no_grad():
                return self._steps(params, generator, sigma)

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
    build_s, ptxas, logs = build_kernels()
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

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

    def case_weights(spec, graph, kind_of, g=None):
        g = gen if g is None else g
        if kind_of in ("base20", "boosted30"):
            return stack_weights(spec, base20 if kind_of == "base20" else boosted30)
        out = {}
        for k in ("cn", "ucn", "vn"):
            # offset mode: CN/UCN offsets in [0, 0.6], VN weights stay scales
            lo, hi = {"ones": (1.0, 1.0), "rand": (0.7, 1.3),
                      "offset": (0.0, 0.6) if k != "vn" else (0.7, 1.3)}[kind_of]
            d = spec.dim(k, graph)
            out[k] = None if d == 0 else (
                lo + (hi - lo) * torch.rand((spec.n_iters, d), generator=g,
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

    # the channel sampler (S1) against its plain version on the same noise,
    # every decoding type and grid, the zero word, codewords and the fold,
    # one sigma and mixed lanes: 0 mismatches as int32 views
    def sampler_case(ch, noise, sig, bits, fold):
        ch.launches.clear()
        out = ch.llr(noise, sig, bits, fold)
        launches = dict(ch.launches)
        want = ch.llr_plain(noise, sig, bits, fold)
        torch.cuda.synchronize()
        mism = int((out.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((out - want).abs().max())
        max_err[awgn_llr.KERNEL] = max(max_err.get(awgn_llr.KERNEL, 0.0), err)
        check(launches == {awgn_llr.KERNEL: 1}, f"sampler: launches {launches}")
        check(bool(torch.isfinite(out).all()), "sampler: non-finite LLR")
        return mism

    from ldpc_error_floor_tpu_torch.channel.awgn import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.codes import Encoder
    sampler_rows = {}
    g_s = torch.Generator(device=dev).manual_seed(12)  # its own draws
    for cname, B in ((WMAN, MAIN_B), (G5, SAMPLER_ODD_B)):
        code = get_code(cname)
        enc = Encoder(graph_of(cname), device=dev)
        one = torch.full((B,), float(code.snr_sigmas([4.0])[0]), device=dev)
        mixed = torch.as_tensor(mix_sigma_lanes(code.snr_sigmas([1.0, 3.0, 5.5]), B),
                                device=dev)
        bits = enc.random_codewords(g_s, B)
        for dec, q in SAMPLER_TYPES:
            ch = AWGNChannel(code, decoding_type=dec, q_bit=q, device=dev)
            cases = {}
            for sname, sig in (("one_sigma", one), ("mixed_lanes", mixed)):
                noise = torch.randn((code.n_full, B), generator=g_s, device=dev)
                for path, b, fold in (("zero", None, False), ("codewords", bits, False),
                                      ("fold", bits, True)):
                    cases[f"{sname}_{path}"] = sampler_case(ch, noise, sig, b, fold)
            # the entry points: one launch each, the plain version on their noise
            for path in ("sample", "sample_codewords_fold"):
                s0 = g_s.get_state()
                ch.launches.clear()
                out = (ch.sample(g_s, mixed) if path == "sample"
                       else ch.sample_codewords(g_s, mixed, bits, fold=True))
                launches = dict(ch.launches)
                g_s.set_state(s0)
                noise = torch.randn((code.n_full, B), generator=g_s, device=dev)
                want = ch.llr_plain(noise, mixed, None if path == "sample" else bits,
                                    path != "sample")
                cases[path] = int((out.view(torch.int32) != want.view(torch.int32)).sum())
                check(launches == {awgn_llr.KERNEL: 1}, f"sampler {path}: launches {launches}")
            sampler_rows[f"{cname[:12]}_B{B}_dec{dec}_q{q}"] = cases
            check(not any(cases.values()), f"sampler {cname} B={B} dec {dec} q {q}: "
                                           f"mismatches {cases}")
    emit({"phase": "sampler_vs_plain", "kernel": awgn_llr.KERNEL, "mismatches": sampler_rows,
          "max_abs_err": max_err[awgn_llr.KERNEL]})

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
               "B": B, "T": T, "launch_shape": list(kern.launch_shape(FIXED)),
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

    # B4 and B5 against their plain version (autograd through the plain scan
    # body): (id, code, sharing, decoding type, T, APP window t0, neural
    # mode, weights, target node); 'post30' = base20's rows for iterations
    # 0-19 and random rows for 20-29, the post block's weights
    from ldpc_error_floor_tpu_torch.models import DecodeResult, Params
    from ldpc_error_floor_tpu_torch.training import (make_optimizer,
                                                     make_train_step,
                                                     multi_iteration_loss)
    spec30_post = WeightSpec(sharing=(3, 3, 3), n_iters=T_BOOST, fixed_iter=T_MAIN)

    def post30_stacked():
        rand = case_weights(WeightSpec(sharing=(3, 3, 3), n_iters=T_BOOST - T_MAIN),
                            wman_graph, "rand")
        st = stack_weights(spec20, base20)
        return {k: torch.cat([st[k], rand[k]]).contiguous() for k in st}

    train_cases = [
        ("m_wman_303_qms_t0_19", WMAN, (3, 0, 3), 2, T_MAIN, T_MAIN - 1, "scale", "rand", 0),
        ("n_wman_303_qms_t0_0", WMAN, (3, 0, 3), 2, T_MAIN, 0, "scale", "rand", 0),
        ("o_wman_333_qms_post30", WMAN, (3, 3, 3), 2, T_BOOST, T_BOOST - 1, "scale", "post30", 0),
        ("p_wman_222_ms", WMAN, (2, 2, 2), 1, T_MAIN, 0, "scale", "rand", 0),
        ("q_wman_303_qms_offset", WMAN, (3, 0, 3), 2, T_MAIN, 0, "offset", "offset", 0),
        ("r_wman_110_qms_per_edge", WMAN, (1, 1, 0), 2, T_MAIN, 0, "scale", "rand", 0),
        ("s_5g_222_qms_systematic", G5, (2, 2, 2), 2, T_MAIN, 0, "scale", "rand", 10),
    ]
    sp_train_cases = [  # neural BP through B4-SP/B5-SP
        ("t_wman_303_sp_t0_19", WMAN, (3, 0, 3), 0, T_MAIN, T_MAIN - 1, "scale", "rand", 0),
        ("u_wman_222_sp_ucn", WMAN, (2, 2, 2), 0, T_MAIN, 0, "scale", "rand", 0),
        ("v_wman_110_sp_per_edge", WMAN, (1, 1, 0), 0, T_MAIN, 0, "scale", "rand", 0),
        ("w_mackay_333_sp", "MACKAY_N96_K48", (3, 3, 3), 0, T_MAIN, 0, "scale", "rand", 0),
        ("x_80211n_303_sp", "802_11n_N648_R56_z27", (3, 0, 3), 0, T_MAIN, 0, "scale", "rand",
         0),
    ]
    FWD, BWD = fused_train.FWD, fused_train.BWD
    FWD_SP, BWD_SP = fused_train.FWD_SP, fused_train.BWD_SP  # B4-SP, B5-SP
    # SP draws its inputs from a generator of its own, so the inputs of
    # every other phase do not depend on the SP cases
    gen_sp = torch.Generator(device=dev).manual_seed(4321)
    for cid, cname, sharing, dec, T, t0, mode, wkind, target in train_cases + sp_train_cases:
        graph = graph_of(cname)
        code = graph.code
        g = gen_sp if dec == 0 else gen
        kf, kb = (FWD_SP, BWD_SP) if dec == 0 else (FWD, BWD)
        spec = spec30_post if wkind == "post30" else WeightSpec(sharing=sharing, n_iters=T)
        stacked = (post30_stacked() if wkind == "post30" else
                   case_weights(spec, graph, wkind, g))
        sig = torch.full((TRAIN_CHECK_B,), float(code.snr_sigmas([3.0])[0]), device=dev)
        llr = AWGNChannel(code, decoding_type=dec, device=dev).sample(g, sig)
        kern = fused_train.FusedTrainKernel(
            graph, DecoderConfig(decoding_type=dec, neural_mode=mode, target_node=target,
                                 app_t0=t0), spec)
        with torch.no_grad():  # B4 alone: the APPs of the window
            apps = kern.apps(stacked, llr)
            apps_p = kern.apps_plain(stacked, llr)
        app_diff = float((apps - apps_p).abs().max())
        max_err[kf] = max(max_err.get(kf, 0.0), app_diff)
        check(apps.shape == (T - t0, kern.target * code.z, TRAIN_CHECK_B)
              and bool(torch.isfinite(apps).all()), f"{cid}: APP stack shape or values")
        check(bool((apps == apps_p).all()) if dec == 2 else
              bool(torch.allclose(apps, apps_p, rtol=1e-4, atol=1e-3)) if dec == 0 else
              app_diff <= 1e-5, f"{cid}: B4 APPs differ from the plain forward ({app_diff})")
        b1_equal = None
        if dec == 0:  # B4-SP is B1-SP's loop: the same last APP, bit for bit
            app_b1 = FusedNMSKernel(graph, DecoderConfig(decoding_type=0, neural_mode=mode),
                                    spec).decode_stats(stacked, llr)[0]
            b1_equal = bool(torch.equal(apps[-1], app_b1))
            check(b1_equal, f"{cid}: B4-SP's last APP differs from B1-SP's")
        # B5: the soft-FER loss (eta 0 with the window, else 0.5)
        etha = 0.0 if t0 else 0.5
        labels = torch.zeros((kern.target * code.z, TRAIN_CHECK_B), device=dev)
        grads = []
        for run in ("kernel", "kernel", "plain"):
            ws = {k: None if v is None else v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
            a = kern.apps(ws, llr) if run == "kernel" else kern.apps_plain(ws, llr)
            multi_iteration_loss(a, labels, 2, etha).backward()
            grads.append({k: v.grad for k, v in ws.items() if v is not None})
            del a, ws
        torch.cuda.synchronize()
        worst, ratio, identical = 0.0, 0.0, True
        for k, g_ref in grads[2].items():
            g = grads[0][k]
            identical &= torch.equal(g, grads[1][k])
            scale = max(float(g_ref.abs().max()), 1e-8)
            err = (g - g_ref).abs()
            worst = max(worst, float(err.max()))
            ratio = max(ratio, float((err / (1e-5 * scale + 1e-4 * g_ref.abs())).max()))
            check(float(g.abs().max()) > 0.0, f"{cid}: zero {k} gradient")
        max_err[kb] = max(max_err.get(kb, 0.0), worst)
        emit({"phase": "kernel_vs_plain", "kernel": f"{kf}+bwd", "case": cid,
              "B": TRAIN_CHECK_B, "T": T, "app_t0": t0, "last_app_equal_b1_sp": b1_equal,
              "launch_shape_fwd": list(fused_train.train_launch_shape(graph, spec, False)),
              "launch_shape_bwd": list(fused_train.train_launch_shape(graph, spec, True,
                                                                      sp=dec == 0)),
              "max_abs_app_diff": app_diff, "max_abs_grad_diff": worst,
              "grad_err_over_tolerance": ratio, "bwd_bit_identical": identical,
              "grad_scale": {k: float(g.abs().max()) for k, g in grads[2].items()}})
        check(kern.launches == {kf: 3, kb: 2}, f"{cid}: launches {kern.launches}")
        check(identical, f"{cid}: two B5 launches differ")
        check(ratio <= 1.0, f"{cid}: gradients outside rtol 1e-4 / atol 1e-5 x max|g| "
                            f"(worst {ratio:.3f} of the tolerance)")
        del grads
        torch.cuda.empty_cache()

    class PlainApps:
        """A decoder whose 'apps' is B4/B5's plain version (for the Adam check)."""

        def __init__(self, dec):
            self.cfg, self.spec, self.kern = dec.cfg, dec.spec, dec.train_kernel

        def apply(self, params: Params, llr, collect):
            apps = self.kern.apps_plain(stack_weights(self.spec, params), llr)
            return DecodeResult(apps[-1], None, None, apps)

    spec_base = WeightSpec(sharing=(3, 0, 3), n_iters=T_MAIN)
    sig_mix = torch.as_tensor(
        [float(s) for s in wman.snr_sigmas([2.0, 2.5, 3.0, 3.5, 4.0])] * (TRAIN_CHECK_B // 5 + 1),
        device=dev)[:TRAIN_CHECK_B]
    labels = torch.zeros((wman.n_full, TRAIN_CHECK_B), device=dev)

    def adam_check(dec_type, g):
        """Three Adam steps on the base block through the kernels and
        through the plain version: (the kernels' decoder, its channel, the
        three batches of LLRs)."""
        dec_k = NMSDecoder(wman, DecoderConfig(decoding_type=dec_type, app_t0=T_MAIN - 1),
                           spec_base, graph=wman_graph, device=dev)
        ch = AWGNChannel(wman, decoding_type=dec_type, device=dev)
        llrs = [ch.sample(g, sig_mix) for _ in range(3)]
        adam_params = {}
        for route, dec in (("kernel", dec_k), ("plain", PlainApps(dec_k))):
            p = init_weights(spec_base, wman_graph, device=dev)
            opt = make_optimizer(p, 1e-2)
            step = make_train_step(dec, spec_base, 2, 0, T_MAIN, static_etha=0.0)
            losses = [float(step(p, opt, x, labels, 0.0)) for x in llrs]
            adam_params[route] = ({k: v.detach() for k, v in p.items() if v is not None},
                                  losses)
        adam_diff = max(float((adam_params["kernel"][0][k] - adam_params["plain"][0][k])
                              .abs().max()) for k in ("cn", "vn"))
        emit({"phase": "adam_kernel_vs_plain", "decoding_type": dec_type, "steps": 3,
              "B": TRAIN_CHECK_B, "max_abs_weight_diff": adam_diff,
              "losses_kernel": adam_params["kernel"][1],
              "losses_plain": adam_params["plain"][1],
              "cn_kernel": adam_params["kernel"][0]["cn"][:, 0].tolist()})
        check(adam_diff <= 1e-5, f"Adam steps (decoding type {dec_type}) through the "
                                 f"kernels differ by {adam_diff}")
        tk = dec_k.train_kernel
        check(tk.launches == {tk.fwd_name: 3, tk.bwd_name: 3},
              f"Adam launches {dec_k.train_kernel.launches}")
        return dec_k, ch, llrs

    dec_k, ch_adam, llrs = adam_check(2, gen)
    dec_sp, ch_sp, llrs_sp = adam_check(0, gen_sp)

    # ---- 3b. the decoder's API at the main path's width ---------------------------
    # base20 at 4.0 dB on the LLRs of the end-to-end seed: all-zero labels
    # through B1, B2 and B3 bit-equal to none, one launch each; labels with
    # a bit set raise before any launch; so does track_syndrome on the card;
    # apply's default is 'apps', through B4
    import numpy as np
    sig_api = torch.full((MAIN_B,), float(wman.snr_sigmas([4.0])[0]), device=dev)
    llr_api = AWGNChannel(wman, device=dev).sample(
        torch.Generator(device=dev).manual_seed(0), sig_api)
    zeros_api = torch.zeros((wman.n_full, MAIN_B), device=dev)
    one_bit = zeros_api.clone()
    one_bit[0, 0] = 1.0
    api_row = {"B": MAIN_B, "snr_db": 4.0, "weights": "base20"}
    for label, cfg_api, collect, kname in (
            ("B1", DecoderConfig(), "stats", "fused_nms_stats"),
            ("B2", DecoderConfig(early_stop=True), "stats", "fused_nms_early_stop"),
            ("B3", DecoderConfig(), "deploy", "fused_nms_deploy")):
        dec_api = NMSDecoder(wman, cfg_api, spec20, graph=wman_graph, device=dev)
        ref = dec_api.decode(base20, llr_api, collect=collect)
        dec_api.kernel.launches.clear()
        out = dec_api.decode(base20, llr_api, labels=zeros_api, collect=collect)
        torch.cuda.synchronize()
        launches = dict(dec_api.kernel.launches)
        equal = (all(torch.equal(x, y) for x, y in zip(out, ref) if x is not None)
                 and torch.equal(torch.signbit(out[0]), torch.signbit(ref[0])))
        try:
            dec_api.decode(base20, llr_api, labels=one_bit, collect=collect)
            raised = False
        except ValueError:
            raised = True
        if label == "B1":
            app_b1 = out[0]
        api_row[label] = {
            "collect": collect, "early_stop": cfg_api.early_stop,
            "kernel_launches": launches, "bit_equal": equal, "one_bit_raised": raised,
            "launches_after_raise": dict(dec_api.kernel.launches),
            "wrong": int(ref.wrong.sum()) if collect == "deploy" else int(ref.uncor_mask.sum())}
        check(launches == {kname: 1}, f"decoder_api {label}: launches {launches}")
        check(equal, f"decoder_api {label}: zero labels not bit-equal to none")
        check(raised and dec_api.kernel.launches == launches,
              f"decoder_api {label}: a set label bit raised {raised}, launches "
              f"{dict(dec_api.kernel.launches)}")
    try:
        NMSDecoder(wman, DecoderConfig(track_syndrome=True), spec20, graph=wman_graph,
                   device=dev)
        api_row["track_syndrome_raised"] = False
    except ValueError:
        api_row["track_syndrome_raised"] = True
    check(api_row["track_syndrome_raised"], "decoder_api: track_syndrome on the card")
    dec_api = NMSDecoder(wman, DecoderConfig(), spec20, graph=wman_graph, device=dev)
    with torch.no_grad():
        apps_api = dec_api.apply(base20, llr_api).apps
    torch.cuda.synchronize()
    tk = dec_api.train_kernel
    api_row["apply_default"] = {
        "apps_shape": list(apps_api.shape), "train_launches": dict(tk.launches),
        "decode_launches": dict(dec_api.kernel.launches),
        "last_app_equal_b1": bool(torch.equal(apps_api[-1], app_b1))}
    emit({"phase": "decoder_api", **api_row})
    check(tuple(apps_api.shape) == (T_MAIN, wman.n_full, MAIN_B),
          f"decoder_api: apply's APPs {tuple(apps_api.shape)}")
    check(tk.launches == {tk.fwd_name: 1} and not dec_api.kernel.launches,
          f"decoder_api: apply launched {dict(tk.launches)}, {dict(dec_api.kernel.launches)}")
    check(api_row["apply_default"]["last_app_equal_b1"],
          "decoder_api: apply's last APP differs from B1's")
    del apps_api, app_b1, out, ref
    torch.cuda.empty_cache()

    # ---- 3c. the decode kernels against the executed-reference traces -----------
    # collect='app_last' through B1 (B1-SP on mackay_sp) on each trace's
    # inputs and weights, held to its last iteration's APP at the
    # tolerances of tests/test_torch_reference_trace.py
    trace_dir = os.path.join(REPO, "tests", "data", "ref_traces")
    trace_files = sorted(f for f in os.listdir(trace_dir) if f.endswith(".npz"))
    check(len(trace_files) >= 6 and "mackay_sp.npz" in trace_files,
          f"reference traces: {trace_files}")
    trace_rows = {}
    for fname in trace_files:
        d = dict(np.load(os.path.join(trace_dir, fname)))
        tcode = get_code(d["code"].tobytes().decode())
        sharing = tuple(int(v) for v in d["sharing"])
        tspec = WeightSpec(sharing=sharing, n_iters=int(d["T"]),
                           fixed_iter=int(d["fixed_iter"]))
        dec_type = int(d["decoding_type"])
        target = int(d["target_node"]) if int(d["target_node"]) != tcode.N else 0
        dec_t = NMSDecoder(tcode, DecoderConfig(decoding_type=dec_type, q_bit=int(d["q_bit"]),
                                                target_node=target), tspec, device=dev)
        tparams = {kind: None if sharing[i] == 0 else torch.tensor(
            np.stack([d[f"w_var_{i}_{t}"] for t in range(tspec.n_rows(kind))]),
            dtype=torch.float32, device=dev) for i, kind in enumerate(("cn", "ucn", "vn"))}
        xa = d["xa"]  # [B, N, z]
        tllr = torch.tensor(xa.transpose(1, 2, 0).reshape(-1, xa.shape[0]),
                            dtype=torch.float32, device=dev).contiguous()
        app_t = dec_t.decode(tparams, tllr, collect="app_last").app_last
        got = app_t[: dec_t.target * dec_t.z].cpu().numpy().T
        want = d["apps"][-1]
        atol = 2e-3 if dec_type == 0 else 2e-4
        err = np.abs(got - want)
        trace_rows[fname[:-4]] = {
            "code": tcode.name, "decoding_type": dec_type, "sharing": list(sharing),
            "T": tspec.n_iters, "B": int(xa.shape[0]), "target_node": target,
            "kernel_launches": dict(dec_t.kernel.launches),
            "max_abs_app_err": float(err.max()), "atol": atol, "rtol": 1e-5,
            "err_over_tolerance": float((err / (atol + 1e-5 * np.abs(want))).max())}
    emit({"phase": "ref_traces", "traces": trace_rows})
    for tid, row in trace_rows.items():
        kname = "fused_nms_stats_sp" if row["decoding_type"] == 0 else "fused_nms_stats"
        check(row["kernel_launches"] == {kname: 1},
              f"ref_traces {tid}: launches {row['kernel_launches']}")
        check(row["err_over_tolerance"] <= 1.0,
              f"ref_traces {tid}: APP {row['max_abs_app_err']} off the trace "
              f"(rtol 1e-5, atol {row['atol']})")

    # ---- 4. end to end: each path -------------------------------------------------
    def simulator(spec, cfg, batch=MAIN_B, stop="genie", dec=2, inner_steps=K_MAIN,
                  cls=None):
        decoder = NMSDecoder(wman, cfg, spec, graph=wman_graph, device=dev)
        channel = AWGNChannel(wman, decoding_type=dec, device=dev)
        return (cls or FERSimulator)(decoder, channel, batch=batch, stop=stop,
                                     inner_steps=inner_steps)

    def drive(label, sim, params, seed, snr=4.0):
        """One run_point of a path, launch counts zeroed just before."""
        sim.decoder.kernel.launches.clear()
        sim.channel.launches.clear()
        pt = sim.run_point(params, snr, torch.Generator(device=dev).manual_seed(seed),
                           max_frames=MAX_FRAMES, target_frame_errors=None)
        launches = dict(sim.decoder.kernel.launches)
        sampler = dict(sim.channel.launches)
        emit({"phase": "end_to_end", "path": label, **vars(pt), "inner_steps": sim.inner_steps,
              "genie_errors": round(pt.fer_genie * pt.frames) if pt.fer_genie == pt.fer_genie else None,
              "kernel_launches": launches, "sampler_launches": sampler})
        check(pt.frames == MAX_FRAMES, f"{label}: {pt.frames} frames, wanted {MAX_FRAMES}")
        check(sum(launches.values()) == MAX_FRAMES // MAIN_B and len(launches) == 1,
              f"{label}: launches {launches} for {MAX_FRAMES // MAIN_B} batches")
        check(sampler == {awgn_llr.KERNEL: MAX_FRAMES // MAIN_B},
              f"{label}: sampler launches {sampler} for {MAX_FRAMES // MAIN_B} batches")
        main_launches.setdefault(awgn_llr.KERNEL, sampler)
        return pt, launches

    main_launches = {}
    sim_fixed = simulator(spec20, DecoderConfig())
    pt, main_launches["fused_nms_stats"] = drive("base20 fixed T=20", sim_fixed, base20, 0)
    check(1.5e-4 <= pt.fer_genie <= 2.7e-4,
          f"base20 FER_genie {pt.fer_genie} outside [1.5e-4, 2.7e-4]")
    check(pt.fer_genie == PR1_FER_GENIE, f"base20 FER_genie {pt.fer_genie}, wanted "
                                         f"{PR1_FER_GENIE}")
    pt_ms, _ = drive("all-ones (plain min-sum) fixed T=20", sim_fixed,
                     init_weights(spec20, wman_graph, device=dev), 1)
    check(pt_ms.fer_genie >= 2.0 * pt.fer_genie,
          f"plain min-sum FER {pt_ms.fer_genie} not 2x base20's {pt.fer_genie}")
    check(round(pt_ms.fer_genie * pt_ms.frames) == PLAIN_MS_ERRORS,
          f"plain min-sum: {pt_ms.fer_genie * pt_ms.frames} genie errors, wanted "
          f"{PLAIN_MS_ERRORS}")

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
    check(round(pt_b.fer_genie * pt_b.frames) == BOOST_ERRORS,
          f"boosted30: {pt_b.fer_genie * pt_b.frames} genie errors, wanted {BOOST_ERRORS}")

    pt_d, main_launches["fused_nms_deploy"] = drive(
        "base20 syndrome stop", simulator(spec20, DecoderConfig(), stop="syndrome"), base20, 0)
    check(pt_d.fer_last >= pt.fer_genie,
          f"syndrome FER_last {pt_d.fer_last} below base20 FER_genie {pt.fer_genie}")
    check(pt_d.fer_undetected <= pt_d.fer_last, "FER_undetected above FER_last")
    check(3.05 <= pt_d.avg_iters <= 3.35, f"mean iterations {pt_d.avg_iters} outside [3.05, 3.35]")
    check(round(pt_d.avg_iters, 5) == SYNDROME_MEAN_ITERS,
          f"mean iterations {pt_d.avg_iters}, wanted {SYNDROME_MEAN_ITERS}")

    spec_bp = WeightSpec(sharing=(0, 0, 0), n_iters=T_MAIN)
    pt_sp, main_launches["fused_nms_stats_sp"] = drive(
        "belief propagation (SP) fixed T=20", simulator(spec_bp, DecoderConfig(decoding_type=0),
                                                        dec=0),
        init_weights(spec_bp, wman_graph, device=dev), 0)
    check(pt_sp.fer_genie <= pt_ms.fer_genie,
          f"SP FER_genie {pt_sp.fer_genie} above plain min-sum's {pt_ms.fer_genie}")

    def floor_point(label, spec, params, snr, frames, jax_ref, inner_steps):
        """A point deep in the error floor with the early stop (seed 0), its
        genie count held to the JAX package's under the two-sample binomial
        test at p >= 0.01; launch counts set to 0 just before."""
        sim = simulator(spec, DecoderConfig(early_stop=True), inner_steps=inner_steps)
        sim.decoder.kernel.launches.clear()
        sim.channel.launches.clear()
        p = sim.run_point(params, snr, torch.Generator(device=dev).manual_seed(0),
                          max_frames=frames, target_frame_errors=None)
        launches = dict(sim.decoder.kernel.launches)
        sampler = dict(sim.channel.launches)
        errors = round(p.fer_genie * p.frames)
        pval = binomial_two_sample_p(errors, p.frames, *jax_ref)
        emit({"phase": "end_to_end", "path": label, **vars(p), "inner_steps": sim.inner_steps,
              "genie_errors": errors, "jax_genie_errors": jax_ref[0],
              "jax_frames": jax_ref[1], "two_sample_binomial_p": pval,
              "kernel_launches": launches, "sampler_launches": sampler})
        check(p.frames == frames, f"{label}: {p.frames} frames")
        check(launches == {"fused_nms_early_stop": frames // MAIN_B},
              f"{label}: launches {launches}")
        check(sampler == {awgn_llr.KERNEL: frames // MAIN_B},
              f"{label}: sampler launches {sampler}")
        check(pval >= 0.01, f"{label}: {errors} genie errors over {frames} frames against "
                            f"JAX's {jax_ref[0]} over {jax_ref[1]} (p {pval})")
        return p, errors

    # the deep error-floor anchor: B2 where the deep runs use it, one batch
    # per host read and eight
    for k in (1, K_MAIN):
        pt_deep, deep_errors = floor_point(
            f"base20 early stop, deep anchor at {DEEP_SNR} dB, K={k}", spec20, base20,
            DEEP_SNR, DEEP_FRAMES, JAX_DEEP, k)
        check(deep_errors == DEEP_ERRORS,
              f"deep anchor at K={k}: {deep_errors} genie errors, wanted {DEEP_ERRORS}")
    # a point in the error floor: the published 50-iteration weights
    spec50 = WeightSpec(sharing=(3, 3, 3), n_iters=50)
    iter50 = load_params(spec50, wman_graph, f"{WMAN}_iter50", device=dev)
    pt50, _ = floor_point(f"iter50 early stop at {ITER50_SNR} dB", spec50, iter50,
                          ITER50_SNR, ITER50_FRAMES, JAX_ITER50, K_MAIN)

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
    # the harvester's rate: a new harvester (cold: the decoder's first use)
    # and the same one again (warm), each from seed 0 as run_collection
    # seeds it, beside a warm run_point of the same path at the same SNR
    from ldpc_error_floor_tpu_torch.sim import UncorHarvester
    harv_sim = simulator(spec20, DecoderConfig(early_stop=True))
    harv = UncorHarvester(harv_sim.decoder, harv_sim.channel, batch=MAIN_B)
    harvest_rate = {}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = harv.collect(base20, 4.2, torch.Generator(device=dev).manual_seed(0),
                           target_words=256)
        dt = time.perf_counter() - t0
        harvest_rate[label] = {"frames": harv.frames, "seconds": dt,
                               "frames_per_sec": harv.frames / dt, "words": int(len(got))}
        check(np.array_equal(got, words), f"harvester ({label}): words differ from "
                                          f"run_collection's")
    for label in ("cold", "warm"):
        p = harv_sim.run_point(base20, 4.2, torch.Generator(device=dev).manual_seed(0),
                               max_frames=MAX_FRAMES, target_frame_errors=None)
        harvest_rate[f"run_point_{label}_frames_per_sec"] = p.frames_per_sec
    emit({"phase": "harvest_rate", "card": smi, "snr_db": 4.2, "batch": MAIN_B,
          "path": "base20, early stop", **harvest_rate})

    # ---- 5b. analyze-uncor over the harvested words -------------------------------
    reports = {}
    for wname, spec, params in (("boosted30", spec30, boosted30), ("base20", spec20, base20)):
        dec_a = NMSDecoder(wman, DecoderConfig(), spec, graph=wman_graph, device=dev)
        rep = classify_failures(dec_a, params, words, batch=MAIN_B)
        reports[wname] = rep
        emit({"phase": "analyze_uncor", "weights": wname, "words": rep.total_words,
              "still_failing": rep.still_failing, "rescued": rep.rescued,
              "top_classes": [[list(ab), n] for ab, n in rep.top_classes[:10]],
              "most_hit_vns": [int(i) for i in (-rep.vn_hits).argsort()[:10]],
              "kernel_launches": dict(dec_a.kernel.launches)})
        check(dec_a.kernel.launches == {"fused_nms_stats": 1},
              f"analyze-uncor {wname}: launches {dec_a.kernel.launches}")
        check(rep.total_words == len(words), f"analyze-uncor {wname}: {rep.total_words} words")
    check(reports["boosted30"].rescued == rescued,
          f"analyze-uncor: boosted30 rescued {reports['boosted30'].rescued}, the harvest "
          f"phase {rescued}")
    check(reports["base20"].rescued == 0,
          f"analyze-uncor: base20 rescued {reports['base20'].rescued} of its own harvest")

    # ---- 6. training end to end ---------------------------------------------------
    import dataclasses

    from ldpc_error_floor_tpu_torch.io import write_weight_file
    from ldpc_error_floor_tpu_torch.models import params_to_blocks
    from ldpc_error_floor_tpu_torch.pipelines import (base_config_wman,
                                                      post_config_wman,
                                                      run_training,
                                                      split_uncor_dataset)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "Weights")
        cfg = dataclasses.replace(base_config_wman(), batch_size=TRAIN_B,
                                  training_num=20 * TRAIN_B, epochs=2, valid_num=2 * TRAIN_B,
                                  learn_rate_start=1e-2, seed=0, out_dir=out_dir)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_training(cfg, verbose=False, device=dev)
        base_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prefix = os.path.join(out_dir, cfg.out_prefix)
        files = {sfx: os.path.exists(prefix + sfx) for sfx in
                 ("_Weight_End20.txt", "_Opt_Weight_End20.txt", "_Performance.txt")}
        metrics = [h["metric"] for h in res.history]
        main_launches[FWD] = main_launches[BWD] = dict(res.launches)
        emit({"phase": "train_base", "config": "base_config_wman", "batch": TRAIN_B,
              "steps_per_epoch": 20, "epochs": 2, "seconds": base_s,
              "peak_device_memory_gb": peak_gb,
              "valid_fer_last_sum": metrics,
              "valid_fer_last": [h["valid"][1] for h in res.history],
              "train_loss": [h["train_loss"] for h in res.history],
              "cn": res.params["cn"][:, 0].tolist(), "vn": res.params["vn"][:, 0].tolist(),
              "files": files, "kernel_launches": res.launches})
        check(all(files.values()), f"training files missing: {files}")
        check(metrics[-1] <= (1.0 - FER_DROP) * metrics[0],
              f"valid FER_last sum {metrics[0]} -> {metrics[-1]}: no {FER_DROP:.0%} drop")
        check(res.launches.get(BWD) == 2 * 20 and res.launches.get(FWD, 0) > 2 * 20
              and res.launches.get(awgn_llr.KERNEL, 0) > 2 * 20,
              f"base training launches {res.launches}")

        # post block on harvested words, base20 the frozen prefix
        uncor = os.path.join(tmp, "Uncor_post.txt")
        t0 = time.perf_counter()
        words = run_collection(ExperimentConfig(code=WMAN, sharing=(3, 3, 3), iters_max=T_MAIN,
                                                snrs=[4.2], seed=1),
                               weight_file=f"{WMAN}_base20", target_words=4096,
                               batch=MAIN_B, out_file=uncor, device=dev)
        harvest_post_s = time.perf_counter() - t0
        in_dir = os.path.join(tmp, "Inputs")
        split_uncor_dataset(uncor, WMAN, in_dir, 2048, 1024, 1024)
        write_weight_file(prefix + "_Opt_Weight_End20.txt", (3, 3, 3),
                          params_to_blocks(spec20, base20))
        post = dataclasses.replace(post_config_wman(), batch_size=512, training_num=2048,
                                   epochs=3, valid_num=1024, test_num=1024,
                                   learn_rate_start=1e-2, seed=0, out_dir=out_dir,
                                   input_dir=in_dir)
        t0 = time.perf_counter()
        res_p = run_training(post, verbose=False, device=dev)
        post_s = time.perf_counter() - t0
    frozen = {k: bool(torch.equal(res_p.params[k][:T_MAIN], base20[k])) for k in base20}
    moved = {k: bool((res_p.params[k][T_MAIN:] != 1.0).any()) for k in base20}
    losses = [h["train_loss"] for h in res_p.history[1:]]
    emit({"phase": "train_post", "config": "post_config_wman", "harvested": int(len(words)),
          "harvest_seconds": harvest_post_s, "batch": 512, "epochs": 3, "seconds": post_s,
          "train_loss": losses, "valid_fer_last": [h["valid"][1] for h in res_p.history],
          "prefix_bit_equal": frozen, "post_rows_moved": moved,
          "kernel_launches": res_p.launches})
    check(len(words) >= 4096, f"harvested {len(words)} words, wanted 4096")
    check(all(frozen.values()), f"frozen prefix rows changed: {frozen}")
    check(all(moved.values()), f"post rows did not move: {moved}")
    check(losses[-1] < losses[0], f"post training loss {losses} does not fall")
    check(res_p.launches.get(BWD) == 3 * 4, f"post training launches {res_p.launches}")

    # neural BP base block: decoding type 0, through B4-SP and B5-SP
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "Weights")
        cfg_sp = dataclasses.replace(base_config_wman(), decoding_type=0, batch_size=TRAIN_B,
                                     training_num=20 * TRAIN_B, epochs=2,
                                     valid_num=2 * TRAIN_B, learn_rate_start=1e-2, seed=0,
                                     out_dir=out_dir)
        t0 = time.perf_counter()
        res_sp = run_training(cfg_sp, verbose=False, device=dev)
        sp_s = time.perf_counter() - t0
        prefix_sp = os.path.join(out_dir, cfg_sp.out_prefix)
        files_sp = {sfx: os.path.exists(prefix_sp + sfx) for sfx in
                    ("_Weight_End20.txt", "_Opt_Weight_End20.txt", "_Performance.txt")}
    metrics_sp = [h["metric"] for h in res_sp.history]
    moved_sp = {k: bool((res_sp.params[k] != 1.0).any()) for k in ("cn", "vn")}
    main_launches[FWD_SP] = main_launches[BWD_SP] = dict(res_sp.launches)
    emit({"phase": "train_base_sp", "config": "base_config_wman, decoding_type 0",
          "batch": TRAIN_B, "steps_per_epoch": 20, "epochs": 2, "seconds": sp_s,
          "valid_fer_last_sum": metrics_sp,
          "valid_fer_last": [h["valid"][1] for h in res_sp.history],
          "train_loss": [h["train_loss"] for h in res_sp.history],
          "cn": res_sp.params["cn"][:, 0].tolist(), "vn": res_sp.params["vn"][:, 0].tolist(),
          "files": files_sp, "rows_moved": moved_sp, "kernel_launches": res_sp.launches})
    check(all(files_sp.values()), f"SP training files missing: {files_sp}")
    check(all(moved_sp.values()), f"SP weights did not move: {moved_sp}")
    check(metrics_sp[-1] <= 1.05 * metrics_sp[0],
          f"SP valid FER_last sum {metrics_sp[0]} -> {metrics_sp[-1]}: more than 5% worse")
    check(set(res_sp.launches) == {FWD_SP, BWD_SP, awgn_llr.KERNEL}
          and res_sp.launches[BWD_SP] == 2 * 20 and res_sp.launches[FWD_SP] > 2 * 20
          and res_sp.launches[awgn_llr.KERNEL] > 2 * 20,
          f"SP training launches {res_sp.launches}")

    # ---- 7. timing ----------------------------------------------------------------
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

    # S1, the sampler's kernel, at the main path's batch: the zero word
    # (QMS q_bit 5, as every run_point samples) and the random-codeword
    # path's fold, its plain version, randn alone and a whole `sample`
    sig40 = torch.full((MAIN_B,), float(wman.snr_sigmas([4.0])[0]), device=dev)
    noise40 = torch.randn((wman.n_full, MAIN_B), generator=gen, device=dev)
    bits40 = Encoder(wman_graph, device=dev).random_codewords(gen, MAIN_B)
    timing["awgn_llr_ms"] = time_ms(lambda: channel.llr(noise40, sig40), reps=50)
    timing["awgn_llr_fold_ms"] = time_ms(lambda: channel.llr(noise40, sig40, bits40, True),
                                         reps=50)
    timing["awgn_llr_plain_ms"] = time_ms(lambda: channel.llr_plain(noise40, sig40), reps=10)
    timing["randn_ms"] = time_ms(lambda: torch.randn((wman.n_full, MAIN_B), generator=gen,
                                                     device=dev), reps=50)
    timing["sample_ms"] = time_ms(lambda: channel.sample(gen, sig40), reps=50)
    bounds[awgn_llr.KERNEL] = sampler_bound(wman.n_full, MAIN_B, quantize=True)
    bounds["awgn_llr_fold"] = sampler_bound(wman.n_full, MAIN_B, quantize=True, fold=True)
    timing["awgn_llr_achieved_gb_per_s"] = (bounds[awgn_llr.KERNEL]["bytes"]
                                            / timing["awgn_llr_ms"] / 1e6)

    for B in (16384, MAIN_B, 262144):  # B1, as in PR 1
        llr = llr_at(4.0, B)
        timing[f"fixed20_ms_B{B}"] = time_ms(lambda: fixed20.decode_stats(st20, llr),
                                             reps=10 if B < 262144 else 4)
    llr = llr_at(4.0)
    timing["fixed20_plain_ms"] = time_ms(lambda: fixed20.decode_stats_plain(st20, llr),
                                         reps=2, warmup=1)
    bounds["fused_nms_stats"] = bound(wman_graph, spec20, MAIN_B)

    for snr in (4.0, 5.0, DEEP_SNR):  # B2 against B1 on the same LLRs (base20, T=20)
        llr = llr_at(snr)
        timing[f"early_stop20_ms_{snr}dB"] = time_ms(lambda: es20.decode_stats(st20, llr), reps=10)
        timing[f"fixed20_ms_{snr}dB"] = time_ms(lambda: fixed20.decode_stats(st20, llr), reps=10)
        err_es = es20.decode_stats(st20, llr)[1]
        timing[f"early_stop20_word_iters_{snr}dB"] = early_stop_word_iters(err_es, G)
        timing[f"early_stop20_tile_iters_{snr}dB"] = tile_iters(err_es, G)
    llr = llr_at(4.0)  # B2 on its main path: boosted30, T=30
    timing["early_stop30_ms"] = time_ms(lambda: es30.decode_stats(st30, llr), reps=10)
    timing["early_stop30_plain_ms"] = time_ms(lambda: es30.decode_stats_plain(st30, llr),
                                              reps=2, warmup=1)
    err_es = es30.decode_stats(st30, llr)[1]
    wi = early_stop_word_iters(err_es, G)
    timing["early_stop30_word_iters"] = wi
    timing["early_stop30_tile_iters"] = tile_iters(err_es, G)
    # the bound had B2 kept the fixed-T kernel's G of 16 words on wman (a
    # word's flags up to its first decode are the same under any G)
    timing["early_stop30_word_iters_G16"] = early_stop_word_iters(err_es, 16)
    bounds["fused_nms_early_stop_at_G16"] = bound(
        wman_graph, spec30, MAIN_B, word_iters=timing["early_stop30_word_iters_G16"])
    bounds["fused_nms_early_stop"] = bound(wman_graph, spec30, MAIN_B, word_iters=wi)

    llr = llr_at(4.0)  # B3 on its main path: base20, T=20
    timing["deploy20_ms"] = time_ms(lambda: dep20.decode_deploy(st20, llr), reps=10)
    timing["deploy20_plain_ms"] = time_ms(lambda: dep20.decode_deploy_plain(st20, llr),
                                          reps=2, warmup=1)
    G_dep = dep20.launch_shape(DEPLOY)[0]
    iters_dep = dep20.decode_deploy(st20, llr)[3]
    # B3's outputs do not depend on G (a word's stop is its own), so its
    # bound counts each word's own iterations; beside it, the bounds of the
    # iterations a block of its own G and of the earlier G of 16 words ran
    def deploy_bound(word_iters):
        return bound(wman_graph, spec20, MAIN_B, word_iters=word_iters,
                     out_bytes_per_word=1 + 4 + 4 + 1, syndrome=True)
    timing["deploy20_word_iters"] = int(iters_dep.sum())
    bounds["fused_nms_deploy"] = deploy_bound(timing["deploy20_word_iters"])
    for g in (G_dep, 16):
        wi = deploy_word_iters(iters_dep, g)
        timing[f"deploy20_word_iters_G{g}"] = wi
        timing[f"deploy20_block_iters_G{g}"] = deploy_block_iters(iters_dep, g, T_MAIN)
        timing[f"deploy20_bound_G{g}"] = deploy_bound(wi)

    for B in (16384, MAIN_B):  # B1-SP on its path: belief propagation, T=20
        llr = llr_at(4.0, B, dec=0)
        timing[f"sp20_ms_B{B}"] = time_ms(lambda: sp20.decode_stats(st_bp, llr), reps=10)
        timing[f"sp20_plain_ms_B{B}"] = time_ms(lambda: sp20.decode_stats_plain(st_bp, llr),
                                                reps=2, warmup=1)
    bounds["fused_nms_stats_sp"] = bound(wman_graph, spec_bp, MAIN_B, sp=True)
    G_fixed, threads, _ = fixed20.launch_shape(FIXED)
    # each decode instance of the main paths (and SP's early stop and
    # syndrome stop): its launch shape, resident blocks per SM and ptxas'
    # registers, stack frame and spills
    ptxas_dec = ptxas_by_instance(logs["fused_nms_stats.cu"], kern_name)
    launch_shapes = {}
    for k, mode in ((fixed20, FIXED), (es30, EARLY_STOP), (dep20, DEPLOY), (sp20, FIXED),
                    (sp20, EARLY_STOP), (sp20, DEPLOY)):
        sp = k.cfg.decoding_type == 0
        kname = kern_name(mode, sp)
        launch_shapes[kname] = {"G_threads_smem": list(k.launch_shape(mode)),
                                "resident_blocks_per_sm": k.resident_blocks(mode),
                                "ptxas": ptxas_dec.get(kname + ("" if sp else "[code]"))}
    check(launch_shapes["fused_nms_stats_sp"]["resident_blocks_per_sm"] >= 2,
          f"B1-SP: {launch_shapes['fused_nms_stats_sp']} resident blocks per SM")
    smem_traffic = (T_MAIN * MAIN_B * 4 * wman_graph.E * wman.z * 6)  # bytes

    # the host loop: one base20 early-stop batch issued eagerly (K = 1, as
    # the port ran every batch before the graph) and one replay of K = 8,
    # each traced after a warm call; then a warm run_point of 2^20 frames of
    # each, traced too
    trace_root = os.path.join(REPO, "build", "host_loop")  # ignored by git
    sigma40 = float(wman.snr_sigmas([4.0])[0])
    host_loop = {}
    for label, k, cls in (("K1_eager", 1, EagerFERSimulator), ("K1_graph", 1, None),
                          (f"K{K_MAIN}_graph", K_MAIN, None)):
        sim = simulator(spec20, DecoderConfig(early_stop=True), inner_steps=k, cls=cls)
        g_t = torch.Generator(device=dev).manual_seed(7)
        first_ms = []
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        for _ in range(2):  # the first read (with the capture), then a warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim._chunk(base20, g_t, sigma40)
            torch.cuda.synchronize()
            first_ms.append(1e3 * (time.perf_counter() - t0))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
        one = traced(lambda: sim._chunk(base20, g_t, sigma40),
                     os.path.join(trace_root, f"{label}_one_read"), "host_read")
        sim.run_point(base20, 4.0, g_t.manual_seed(0), max_frames=MAIN_B * K_MAIN,
                      target_frame_errors=None)  # warm: the point's graph
        pts = []
        whole = traced(lambda: pts.append(sim.run_point(
            base20, 4.0, g_t.manual_seed(0), max_frames=MAX_FRAMES, target_frame_errors=None)),
            os.path.join(trace_root, f"{label}_run_point"), "run_point")
        pt_t = pts[-1]
        sampler_ms = {"one_host_read": sampler_ms_per_batch(one, k),
                      "run_point_2^20": sampler_ms_per_batch(whole, MAX_FRAMES // MAIN_B)}
        host_loop[label] = {"one_host_read": one, "run_point_2^20": whole,
                            "sampler_ms_per_batch": sampler_ms,
                            "run_point_frames_per_sec_traced": pt_t.frames_per_sec,
                            "first_read_ms": first_ms[0], "second_read_ms": first_ms[1],
                            "peak_device_gb_above_start": peak_gb,
                            "batches_per_read": k}
        check(round(pt_t.fer_genie * pt_t.frames) == round(PR1_FER_GENIE * MAX_FRAMES),
              f"host loop {label}: {pt_t.fer_genie * pt_t.frames} genie errors")
        check(sum(one["kernel_ms"].get(kn, 0.0) for kn in one["kernel_ms"]
                  if "fused_nms_kernel" in kn) > 0.0,
              f"host loop {label}: no decode kernel in the trace ({list(one['kernel_ms'])})")
        check(sampler_ms["run_point_2^20"]["awgn_llr"] > 0.0,
              f"host loop {label}: no awgn_llr kernel in the trace ({list(whole['kernel_ms'])})")
    emit({"phase": "host_loop", "card": smi, "traces": trace_root, **host_loop})

    # run_point frames/s and the kernel's share of a batch, K = 1 eager,
    # K = 1 graph, K = 8 graph: a point on a new simulator (cold: the graph's
    # capture and the decoder's first use included), then the same point
    # again on the same generator (warm)
    st_bp_params = init_weights(spec_bp, wman_graph, device=dev)
    host_paths = {  # (spec, config, stop, decoding type, params, SNR, frames, kernel ms)
        "base20_early_stop": (spec20, DecoderConfig(early_stop=True), "genie", 2, base20, 4.0,
                              MAX_FRAMES, timing["early_stop20_ms_4.0dB"]),
        "boosted30_early_stop": (spec30, DecoderConfig(early_stop=True), "genie", 2, boosted30,
                                 4.0, MAX_FRAMES, timing["early_stop30_ms"]),
        "base20_syndrome": (spec20, DecoderConfig(), "syndrome", 2, base20, 4.0, MAX_FRAMES,
                            timing["deploy20_ms"]),
        "bp_sp": (spec_bp, DecoderConfig(decoding_type=0), "genie", 0, st_bp_params, 4.0,
                  MAX_FRAMES, timing[f"sp20_ms_B{MAIN_B}"]),
        "deep_anchor_5.5dB": (spec20, DecoderConfig(early_stop=True), "genie", 2, base20,
                              DEEP_SNR, DEEP_FRAMES, timing[f"early_stop20_ms_{DEEP_SNR}dB"]),
    }
    host_rows = {}
    for pname, (spec, cfg, stop, dt, params, snr, frames, kern_ms) in host_paths.items():
        row, outcomes = {"kernel_ms": kern_ms}, set()
        for label, k, cls in (("K1_eager", 1, EagerFERSimulator), ("K1_graph", 1, None),
                              (f"K{K_MAIN}_graph", K_MAIN, None)):
            sim = simulator(spec, cfg, stop=stop, dec=dt, inner_steps=k, cls=cls)
            g_t = torch.Generator(device=dev)
            cold, p = (sim.run_point(params, snr, g_t.manual_seed(0), max_frames=frames,
                                     target_frame_errors=None) for _ in range(2))
            ms_batch = 1e3 * MAIN_B / p.frames_per_sec
            row[label] = {"frames_per_sec": p.frames_per_sec, "ms_per_batch": ms_batch,
                          "kernel_share": kern_ms / ms_batch,
                          "frames_per_sec_cold": cold.frames_per_sec}
            for q in (cold, p):
                outcomes.add(tuple(None if v != v else v for k_, v in vars(q).items()
                                   if k_ not in ("seconds", "frames_per_sec")))
        host_rows[pname] = row
        check(len(outcomes) == 1, f"{pname}: the counters differ between K = 1 eager, "
                                  f"K = 1 graph and K = {K_MAIN} graph, cold or warm: "
                                  f"{outcomes}")
    timing["run_point_host_loop"] = host_rows
    timing["iter50_frames_per_sec"] = pt50.frames_per_sec
    emit({"phase": "timing", "card": smi, **timing,
          "run_point_frames_per_sec": {"base20_fixed": pt.frames_per_sec,
                                       "base20_early_stop": pt_es.frames_per_sec,
                                       "boosted30_early_stop": pt_b.frames_per_sec,
                                       "boosted30_fixed": pt_bf.frames_per_sec,
                                       "base20_syndrome": pt_d.frames_per_sec,
                                       "bp_sp": pt_sp.frames_per_sec},
          "bounds": bounds, "words_per_block": G_fixed, "threads": threads,
          "words_per_block_deploy": G_dep, "launch_shapes": launch_shapes,
          "ptxas_decode": ptxas_dec,
          "smem_ms_this_design_fixed20": smem_traffic / SMEM_BYTES_PER_S * 1e3})

    # B4 and B5 at the training batch on the base block ((3,0,3), T=20) and
    # the post block ((3,3,3), T=30, base20's rows 0-19), APP window t0=T-1
    # (eta 0), against the plain version on the same inputs in chunks of
    # TRAIN_CHECK_B words (one chunk's autograd graph at a time)
    from ldpc_error_floor_tpu_torch.channel.awgn import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.training import make_epoch_step
    sig_train = torch.as_tensor(
        mix_sigma_lanes(wman.snr_sigmas(base_config_wman().snrs), TRAIN_B), device=dev)

    def plain_chunks(kern, ws, llr, backward):
        """The plain version on llr in chunks of TRAIN_CHECK_B words: its ms
        (the forward, or the backward alone); with `backward` also the
        clipped APPs, the loss and the weight gradients of the whole batch
        (each chunk's loss and gradients scaled by chunk / B)."""
        total, apps, loss, grads = 0.0, [], 0.0, {}
        B = llr.shape[1]
        labels_c = torch.zeros((wman.n_full, TRAIN_CHECK_B), device=dev)
        for c in range(0, B, TRAIN_CHECK_B):
            w = {k: None if v is None else v.detach().requires_grad_(True)
                 for k, v in ws.items()}
            x = llr[:, c:c + TRAIN_CHECK_B].contiguous()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            a = kern.apps_plain(w, x)
            if backward:
                loss_c = multi_iteration_loss(a, labels_c, 2, 0.0)
                torch.cuda.synchronize()
                start.record()
                loss_c.backward()
            stop.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(stop)
            if backward:
                frac = x.shape[1] / B
                apps.append(a.detach())
                loss += frac * float(loss_c.detach())
                for k, v in w.items():
                    if v is not None:
                        grads[k] = grads[k] + frac * v.grad if k in grads else frac * v.grad
            del a, w
        return total, (torch.cat(apps, dim=2) if apps else None), loss, grads

    train_timing, train_bounds = {}, {}
    train_blocks = {  # (spec, rows trained, decoding type, weights)
        "base": (spec_base, 0, T_MAIN, 2, case_weights(spec_base, wman_graph, "rand")),
        "post": (spec30_post, T_MAIN, T_BOOST, 2, post30_stacked()),
        "base_sp": (spec_base, 0, T_MAIN, 0,
                    case_weights(spec_base, wman_graph, "rand", gen_sp))}
    for bname, (spec, start, end, dt, ws) in train_blocks.items():
        T = spec.n_iters
        sp = dt == 0
        ch, g = (ch_sp, gen_sp) if sp else (ch_adam, gen)
        kern = fused_train.FusedTrainKernel(
            wman_graph, DecoderConfig(decoding_type=dt, app_t0=T - 1), spec)
        llr = ch.sample(g, sig_train)
        w3 = (ws["cn"], ws["ucn"], ws["vn"])
        train_timing[f"{bname}_fwd_ms"] = time_ms(lambda: kern._forward(w3, llr, True), reps=5)
        apps_pre, hist, cres = kern._forward(w3, llr, True)
        # B4 under no_grad (the evaluator's launch) writes the APPs alone
        alone_mismatches = int((kern._forward(w3, llr, False)[0] != apps_pre).sum())
        a = torch.clamp(apps_pre, -20.0, 20.0).requires_grad_(True)
        loss_k = multi_iteration_loss(a, torch.zeros((wman.n_full, TRAIN_B), device=dev), 2,
                                      0.0)
        loss_k.backward()
        g_apps = a.grad.contiguous()
        train_timing[f"{bname}_bwd_ms"] = time_ms(
            lambda: kern._backward(w3, llr, hist, cres, apps_pre, g_apps), reps=5)
        g_k = dict(zip(("cn", "ucn", "vn"), kern._backward(w3, llr, hist, cres, apps_pre,
                                                             g_apps)))
        # two launches on the same residuals: bit-identical gradients
        g_again = kern._backward(w3, llr, hist, cres, apps_pre, g_apps)
        bwd_identical = all(g is None or torch.equal(g_k[k], g)
                            for k, g in zip(("cn", "ucn", "vn"), g_again))
        del g_again
        apps_k = a.detach()
        del hist, cres, apps_pre, a
        torch.cuda.empty_cache()
        train_timing[f"{bname}_fwd_plain_ms"] = plain_chunks(kern, ws, llr, False)[0]
        (train_timing[f"{bname}_bwd_plain_ms"], apps_p, loss_p,
         g_p) = plain_chunks(kern, ws, llr, True)
        # the main path's B4 (streaming, and alone) and B5 at B=32768 against
        # the plain version on the same words
        worst, ratio = 0.0, 0.0
        for k, g_ref in g_p.items():
            err = (g_k[k] - g_ref).abs()
            worst = max(worst, float(err.max()))
            scale = max(float(g_ref.abs().max()), 1e-8)
            ratio = max(ratio, float((err / (1e-5 * scale + 1e-4 * g_ref.abs())).max()))
        app_diff = float((apps_k - apps_p).abs().max())
        # words whose soft-FER term (the sign of the worst bit) differs
        decisions = int((torch.sign(torch.amin(-apps_k[-1], dim=0))
                         != torch.sign(torch.amin(-apps_p[-1], dim=0))).sum())
        par = {
            "max_abs_app_diff": app_diff,
            "app_mismatches": int((apps_k != apps_p).sum()),
            "apps_within_sp_tolerance": bool(torch.allclose(apps_k, apps_p, rtol=1e-4,
                                                            atol=1e-3)),
            "decision_mismatches": decisions,
            "stream_vs_alone_mismatches": alone_mismatches,
            "bwd_bit_identical": bwd_identical,
            "loss_kernel": float(loss_k.detach()), "loss_plain": loss_p,
            "max_abs_grad_diff": worst, "grad_err_over_tolerance": ratio,
            "grad_scale": {k: float(g.abs().max()) for k, g in g_p.items()}}
        del apps_p, apps_k
        kf, kb = (FWD_SP, BWD_SP) if sp else (FWD, BWD)
        emit({"phase": "kernel_vs_plain", "kernel": f"{kf}+bwd",
              "case": f"{bname}_block_B{TRAIN_B}", "B": TRAIN_B, "T": T, "app_t0": T - 1,
              **par})
        max_err[kf] = max(max_err[kf], app_diff)
        max_err[kb] = max(max_err[kb], worst)
        check(par["apps_within_sp_tolerance"] if sp else par["app_mismatches"] == 0,
              f"{bname} B={TRAIN_B}: B4's streaming APPs differ from the plain version")
        check(par["stream_vs_alone_mismatches"] == 0,
              f"{bname} B={TRAIN_B}: B4 alone and streaming give different APPs")
        check(bwd_identical, f"{bname} B={TRAIN_B}: two B5 launches differ")
        check(decisions == 0, f"{bname} B={TRAIN_B}: {decisions} words' soft-FER terms "
                              "differ from the plain version's")
        check(abs(par["loss_kernel"] - loss_p) <= 1e-6 * abs(loss_p),
              f"{bname} B={TRAIN_B}: loss {par['loss_kernel']} against plain {loss_p}")
        check(ratio <= 1.0, f"{bname} B={TRAIN_B}: B5 gradients outside rtol 1e-4 / atol "
                            f"1e-5 x max|g| (worst {ratio:.3f} of the tolerance)")
        train_bounds[f"{bname}_fwd"] = train_bound(kern, TRAIN_B, False)
        train_bounds[f"{bname}_bwd"] = train_bound(kern, TRAIN_B, True)
        # one whole step: sampling, B4, loss, B5, Adam, clip (5 steps timed)
        dec = NMSDecoder(wman, DecoderConfig(decoding_type=dt, app_t0=T - 1), spec,
                         graph=wman_graph, device=dev)
        p = init_weights(spec, wman_graph, device=dev)
        opt = make_optimizer(p, 1e-2)
        epoch = make_epoch_step(dec, spec, 2, start, end, 0, n_steps=5,
                                labels=torch.zeros((wman.n_full, TRAIN_B), device=dev),
                                channel=ch, sigmas=sig_train, static_etha=0.0)
        step_ms = time_ms(lambda: epoch(p, opt, g, 0.0), reps=2, warmup=1) / 5
        train_timing[f"{bname}_step_ms"] = step_ms
        train_timing[f"{bname}_trained_cw_per_s"] = TRAIN_B / step_ms * 1e3
        torch.cuda.empty_cache()
    # the plain step (autograd through the plain version) at TRAIN_CHECK_B
    p = init_weights(spec_base, wman_graph, device=dev)
    opt = make_optimizer(p, 1e-2)
    plain_step = make_train_step(PlainApps(dec_k), spec_base, 2, 0, T_MAIN, static_etha=0.0)
    x = llrs[0]
    train_timing["base_plain_step_ms_B4096"] = time_ms(
        lambda: plain_step(p, opt, x, labels, 0.0), reps=2, warmup=1)
    p = init_weights(spec_base, wman_graph, device=dev)
    opt = make_optimizer(p, 1e-2)
    plain_step = make_train_step(PlainApps(dec_sp), spec_base, 2, 0, T_MAIN, static_etha=0.0)
    x = llrs_sp[0]
    train_timing["base_sp_plain_step_ms_B4096"] = time_ms(
        lambda: plain_step(p, opt, x, labels, 0.0), reps=2, warmup=1)
    # each kernel's achieved device-memory rate (the bound's bytes over its
    # time) and its time as a multiple of its bound
    achieved = {f"{blk}_{d}": {
        "gb_per_s": train_bounds[f"{blk}_{d}"]["bytes"] / train_timing[f"{blk}_{d}_ms"] / 1e6,
        "x_bound": train_timing[f"{blk}_{d}_ms"] / train_bounds[f"{blk}_{d}"]["bound_ms"]}
        for blk in train_blocks for d in ("fwd", "bwd")}
    emit({"phase": "train_timing", "card": smi, "B": TRAIN_B, **train_timing,
          "bounds": train_bounds, "achieved": achieved,
          "ptxas_train": ptxas["fused_nms_train.cu"],
          "launch_shape_fwd": list(fused_train.train_launch_shape(wman_graph, spec_base, False)),
          "launch_shape_bwd": list(fused_train.train_launch_shape(wman_graph, spec_base, True)),
          "launch_shape_fwd_post": list(fused_train.train_launch_shape(wman_graph, spec30_post,
                                                                       False)),
          "launch_shape_bwd_post": list(fused_train.train_launch_shape(wman_graph, spec30_post,
                                                                       True)),
          "launch_shape_fwd_sp": list(fused_train.train_launch_shape(wman_graph, spec_base,
                                                                     False, sp=True)),
          "launch_shape_bwd_sp": list(fused_train.train_launch_shape(wman_graph, spec_base,
                                                                     True, sp=True))})
    # the redesigned SP training pair keeps no local array and, on the main
    # path, spills nothing
    ptxas_tr = ptxas_by_instance(logs["fused_nms_train.cu"], kern_name)
    emit({"phase": "ptxas_train", "instances": ptxas_tr})
    # (the instances for checks past one chunk spill at the pair's bound, where
    # they ran faster than at SP's, PERF.md)
    for kname in (FWD_SP, BWD_SP):
        rep = ptxas_tr.get(kname, {})
        check(rep.get("stack") == 0 and rep.get("spill_stores") == 0
              and rep.get("spill_loads") == 0,
              f"{kname}: ptxas reports {rep} (stack bytes or spills)")
    bounds[FWD], bounds[BWD] = train_bounds["base_fwd"], train_bounds["base_bwd"]
    bounds[FWD_SP], bounds[BWD_SP] = train_bounds["base_sp_fwd"], train_bounds["base_sp_bwd"]

    # ---- 8. the mesh ----------------------------------------------------------------
    # (i) base20's early-stop and syndrome-stop paths through an NCCL world of
    # one, launch counts set to 0 just before each and read just after
    import socket

    import torch.distributed as dist

    from ldpc_error_floor_tpu_torch.io import append_uncor_file
    from ldpc_error_floor_tpu_torch.parallel import DataMesh, data_mesh, rank_generator
    from ldpc_error_floor_tpu_torch.sim import UncorHarvester
    mesh = data_mesh(device="cuda")
    check(mesh.world == 1 and dist.get_backend() == "nccl",
          f"world of one: {mesh}, backend {dist.get_backend()}")
    mesh_row = {"backend": dist.get_backend(), "device": str(mesh.device)}
    mesh_sims, _ = mesh_paths(dev, mesh)
    plain_sims, _ = mesh_paths(dev)
    n_reads = MAX_FRAMES // (MAIN_B * K_MAIN)
    g_m = torch.Generator(device=dev)  # one generator: a warm point needs no capture
    for (label, sim), kname in zip(mesh_sims, ("fused_nms_early_stop", "fused_nms_deploy")):
        sim.decoder.kernel.launches.clear()
        p = sim.run_point(base20, 4.0, g_m.manual_seed(0), max_frames=MAX_FRAMES,
                          target_frame_errors=None)
        launches = dict(sim.decoder.kernel.launches)
        mesh_row[label] = {**point_counts(p, wman.n_full), "cold_frames_per_sec":
                           p.frames_per_sec, "kernel_launches": launches}
        check(launches == {kname: MAX_FRAMES // MAIN_B},
              f"mesh {label}: launches {launches}")
    anchor = round(pt_es.fer_genie * pt_es.frames)  # the early-stop path without the mesh
    check(mesh_row["early_stop"]["genie_errors"] == anchor,
          f"mesh early stop: {mesh_row['early_stop']['genie_errors']} genie errors, "
          f"wanted {anchor}")
    iters = mesh_row["syndrome"]["iters_sum"] / MAX_FRAMES
    check(round(iters, 5) == SYNDROME_MEAN_ITERS, f"mesh syndrome stop: {iters} iterations")
    # warm frames/s of the early-stop path, non-mesh and mesh in turns
    plain_sims[0][1].run_point(base20, 4.0, g_m.manual_seed(0), max_frames=MAX_FRAMES,
                               target_frame_errors=None)  # its cold run
    warm = {"plain": [], "mesh": []}
    for which in ("plain", "mesh", "mesh", "plain"):
        sim = (plain_sims if which == "plain" else mesh_sims)[0][1]
        p = sim.run_point(base20, 4.0, g_m.manual_seed(0), max_frames=MAX_FRAMES,
                          target_frame_errors=None)
        warm[which].append(p.frames_per_sec)
        check(round(p.fer_genie * p.frames) == anchor,
              f"warm {which}: {p.fer_genie * p.frames} genie errors")
    mesh_row["warm_frames_per_sec"] = warm
    # the all-reduce in a traced warm point: the card's and the host's time
    # of the collective per host read
    tdir = os.path.join(trace_root, "mesh_run_point")
    mesh_row["run_point_trace"] = traced(
        lambda: mesh_sims[0][1].run_point(base20, 4.0, g_m.manual_seed(0),
                                          max_frames=MAX_FRAMES, target_frame_errors=None),
        tdir, "run_point")
    mesh_row["all_reduce_trace"] = collective_trace(tdir, n_reads)

    # (ii) the base block through run_training, an NCCL world of one against
    # no mesh: 3 steps at TRAIN_B, bit-equal weights
    trained = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, m in (("plain", None), ("mesh", mesh)):
            cfg = dataclasses.replace(base_config_wman(), batch_size=TRAIN_B,
                                      training_num=3 * TRAIN_B, epochs=1,
                                      valid_num=TRAIN_B, learn_rate_start=1e-2, seed=0,
                                      out_dir=os.path.join(tmp, label))
            t0 = time.perf_counter()
            trained[label] = (run_training(cfg, verbose=False, device=dev, mesh=m),
                              time.perf_counter() - t0)
    res_m = trained["mesh"][0]
    mesh_row["train"] = {label: {"seconds": t, "train_loss": [h["train_loss"] for h in
                                                              r.history],
                                 "valid_fer_last_sum": [h["metric"] for h in r.history],
                                 "kernel_launches": r.launches}
                         for label, (r, t) in trained.items()}
    check(res_m.launches.get(BWD) == 3 and res_m.launches.get(FWD, 0) > 3,
          f"mesh training launches {res_m.launches}")
    check(all(v is None or torch.equal(v, trained["plain"][0].params[k])
              for k, v in res_m.params.items()),
          "mesh training: weights differ from the run without the mesh")
    check(res_m.history == trained["plain"][0].history,
          "mesh training: losses or metrics differ from the run without the mesh")
    # the global draw: at W ranks each rank samples the whole batch of
    # TRAIN_B words to decode TRAIN_B / W of them
    g_s = torch.Generator(device=dev).manual_seed(0)
    ch_s = AWGNChannel(wman, device=dev)
    mesh_row["train_sample_ms"] = {
        f"B{n}": time_ms(lambda: ch_s.sample(g_s, sig_train[:n]), reps=20)
        for n in (TRAIN_B, TRAIN_B // MESH_RANKS)}
    mesh_row["train_step_ms"] = train_timing["base_step_ms"]

    # (iii) MESH_RANKS gloo ranks sharing the card, each a process of this
    # script under its own timeout, against the rank generators run here
    with tempfile.TemporaryDirectory() as mdir:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), port, mdir], cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(MESH_RANKS)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=MESH_TIMEOUT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        mesh_row["two_rank_seconds"] = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            check(proc.returncode == 0, f"mesh rank {r} exited {proc.returncode}:\n"
                                        f"{log[-3000:]}")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(mdir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
        # the per-rank sum: both rank generators, each at its share of the batch
        g0 = torch.Generator(device=dev).manual_seed(0)
        s0 = g0.get_state()

        def rank_gens():
            gens = []
            for r in range(MESH_RANKS):
                g0.set_state(s0)
                gens.append(rank_generator(g0, DataMesh(r, MESH_RANKS, dev)))
            return gens

        local_sims, _ = mesh_paths(dev, batch=MAIN_B // MESH_RANKS)
        pooled = {}
        for label, sim in local_sims:
            want = {}
            for g in rank_gens():
                p = sim.run_point(base20, 4.0, g, max_frames=MAX_FRAMES // MESH_RANKS,
                                  target_frame_errors=None)
                for k, v in point_counts(p, wman.n_full).items():
                    want[k] = want.get(k, 0) + v
            pooled[label] = want
            check(all(rk[label] == want for rk in ranks),
                  f"two ranks, {label}: {[rk[label] for rk in ranks]} against the per-rank "
                  f"sum {want}")
            check(all(sum(rk[label + "_launches"].values()) == MAX_FRAMES // MAIN_B
                      for rk in ranks), f"two ranks, {label}: launches "
                                        f"{[rk[label + '_launches'] for rk in ranks]}")
        # the harvest: both rank generators in step, at the rank's batch
        h = UncorHarvester(local_sims[0][1].decoder, local_sims[0][1].channel,
                           batch=MAIN_B // MESH_RANKS)
        sigma42 = float(np.float32(wman.snr_sigmas([4.2])[0]))
        rows, n_words, frames = [[] for _ in range(MESH_RANKS)], 0, 0
        gens = rank_gens()
        while n_words < MESH_WORDS:
            for r, g in enumerate(gens):
                count, picked = h._step(base20, g, sigma42)
                kept = min(int(count), h.cap)
                rows[r].append(picked[:, :kept].T.cpu().numpy())
                n_words += kept
            frames += MAIN_B
        part_rows = [read_uncor_file(os.path.join(mdir, f"uncor.txt.part{r}"))
                     for r in range(MESH_RANKS)]
        want_path = os.path.join(mdir, "want.txt")
        same_rows = []
        for r in range(MESH_RANKS):  # the rows through the Uncor format
            if os.path.exists(want_path):
                os.remove(want_path)
            append_uncor_file(want_path, np.concatenate(rows[r]))
            same_rows.append(bool(np.array_equal(read_uncor_file(want_path), part_rows[r])))
        union = np.concatenate(part_rows)
        # one train step, the ranks' lanes against a world of one's
        loss1, w1, _ = mesh_train_once(dev)
        w_rank = [dict(np.load(os.path.join(mdir, f"weights_{r}.npz")))
                  for r in range(MESH_RANKS)]
    worst = max(float(np.max(np.abs(w[k] - w1[k].numpy())
                             / np.maximum(np.abs(w1[k].numpy()), 1e-30)))
                for w in w_rank for k in w)
    mesh_row["two_ranks"] = {
        "backend": ranks[0]["backend"], "counters": pooled, "harvest": ranks[0]["harvest"],
        "cold_frames_per_sec": {label: [rk[label + "_frames_per_sec"] for rk in ranks]
                                for label, _ in local_sims},
        "harvest_frames_here": frames, "harvest_words_here": n_words,
        "harvest_rows_per_rank": [len(x) for x in part_rows],
        "loss": [rk["loss"] for rk in ranks], "loss_world_of_one": loss1,
        "weights_max_rel_diff": worst,
        "train_launches": [rk["train_launches"] for rk in ranks]}
    emit({"phase": "mesh", "card": smi, **mesh_row})
    check(all(rk["backend"] == "gloo" and rk["world"] == MESH_RANKS for rk in ranks),
          f"two ranks: {[(rk['backend'], rk['world']) for rk in ranks]}")
    check(all(rk["harvest"]["frames"] == frames and rk["harvest"]["words"] == len(part_rows[r])
              for r, rk in enumerate(ranks)),
          f"two ranks' harvest {[rk['harvest'] for rk in ranks]} against {frames} frames here")
    check(all(same_rows) and len(union) == n_words,
          f"two ranks' .part files: rows equal to the rank generators' {same_rows}, "
          f"{len(union)} rows against {n_words}")
    check(all(abs(rk["loss"] - loss1) <= 1e-5 * abs(loss1) for rk in ranks),
          f"two ranks' loss {[rk['loss'] for rk in ranks]} against {loss1}")
    check(worst <= 1e-5, f"two ranks' weights {worst} off a world of one's (rtol 1e-5)")
    check(all(rk["train_launches"] == {FWD: 1, BWD: 1} for rk in ranks),
          f"two ranks' train launches {[rk['train_launches'] for rk in ranks]}")
    dist.destroy_process_group()

    # (iv) the launcher: the CLI's --mesh over the host's cards, one NCCL
    # rank per card, against the rank generators run here
    emit({"phase": "mesh_launcher", "card": smi, **launcher_phase(dev)})

    # ---- 9. summary -----------------------------------------------------------------
    src = "ldpc_error_floor_tpu_torch/csrc/fused_nms_stats.cu"
    src_train = "ldpc_error_floor_tpu_torch/csrc/fused_nms_train.cu"
    src_awgn = "ldpc_error_floor_tpu_torch/csrc/awgn_llr.cu"
    rows = [  # (name, source, replaces, ms, plain ms)
        ("fused_nms_stats", src, "ldpc_error_floor_tpu/ops/pallas_decoder.py:435",
         timing[f"fixed20_ms_B{MAIN_B}"], timing["fixed20_plain_ms"]),
        ("fused_nms_early_stop", src, "ldpc_error_floor_tpu/ops/pallas_decoder.py:747",
         timing["early_stop30_ms"], timing["early_stop30_plain_ms"]),
        ("fused_nms_deploy", src, "ldpc_error_floor_tpu/ops/pallas_decoder.py:692",
         timing["deploy20_ms"], timing["deploy20_plain_ms"]),
        ("fused_nms_stats_sp", src, "ldpc_error_floor_tpu/ops/pallas_decoder.py:567",
         timing[f"sp20_ms_B{MAIN_B}"], timing[f"sp20_plain_ms_B{MAIN_B}"]),
        (FWD, src_train, "ldpc_error_floor_tpu/ops/pallas_train.py:366",
         train_timing["base_fwd_ms"], train_timing["base_fwd_plain_ms"]),
        (BWD, src_train, "ldpc_error_floor_tpu/ops/pallas_train.py:652",
         train_timing["base_bwd_ms"], train_timing["base_bwd_plain_ms"]),
        (FWD_SP, src_train, "ldpc_error_floor_tpu/ops/pallas_train.py:527",
         train_timing["base_sp_fwd_ms"], train_timing["base_sp_fwd_plain_ms"]),
        (BWD_SP, src_train, "ldpc_error_floor_tpu/ops/pallas_train.py:235",
         train_timing["base_sp_bwd_ms"], train_timing["base_sp_bwd_plain_ms"]),
        (awgn_llr.KERNEL, src_awgn, "ldpc_error_floor_tpu/channel/awgn.py:61-89",
         timing["awgn_llr_ms"], timing["awgn_llr_plain_ms"]),
    ]
    emit({"kernels": [{
        "name": kname, "route": "cuda", "source": source, "replaces": replaces,
        "launches": main_launches[kname][kname], "max_abs_err": max_err[kname],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[kname]["bound_ms"],
        "bound_by": bounds[kname]["bound_by"], "library_ms": None}
        for kname, source, replaces, ms, plain_ms in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card and skip without one.  They import nothing of
JAX, so they run on a machine without it; `tests/conftest.py` imports JAX,
so on the card run them without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances: QMS counters integer-equal and APPs bit-equal (==, and the
sign bit of every APP, zeros included: under QMS the kernels keep their
state in integer codes and must give back the float sums' signed zeros);
MS and MS_RAW counters integer-equal and APPs within atol 1e-4 / rtol
1e-5.  The genie early stop is held to the plain version grouped as the
kernel groups words (under QMS each word alone, B2's stop per word; G per
block for the float states), and its genie-failure mask to the fixed-T
kernel's exactly; under QMS both are checked on every grid, with batches
that are not a multiple of G, small and large, and B2 on the benchmark's
two codes with its engagement pair (words and lane-steps); B2 over a host
read of K batches, one launch whose totals equal the reductions of K
launches' rows (two reads in a row, a ragged batch at K = 1 and K = 2),
its pair counting K*B words, and a replayed chunk running it once beside K
sampler launches and no reduction.  The syndrome stop's per-word outputs are integer-equal to its
plain version.  SP (tanhf/atanhf are not PyTorch's, and the plain version's
cumprod may associate differently on the card): APPs within atol 1e-3 /
rtol 1e-4, counters equal on at least 99.9% of words.  The training pair:
B4's APP stack (full and windowed to the last iteration) QMS bit-equal, MS
and MS_RAW within atol 1e-5, SP (B4-SP) within atol 1e-3 / rtol 1e-4, as
B1-SP, against the plain forward, and the streaming launch's bit-equal to
the no_grad launch's; B4-SP's last APP bit-equal to B1-SP's (the same loop
and arithmetic); B5's (and B5-SP's) weight gradients against autograd
through the plain version within rtol 1e-4 and atol 1e-5 x max|g|, and
bit-identical over two launches, also for ragged batches (the residual
streams' last tile padded).  The SP cases cover every way B5-SP sums a
weight gradient and checks of more than one chunk of 16 slots (802.11n,
BCH_63_51).  The host loop's CUDA graph (`sim/fer.py`): a replay of K
steps counts exactly what K eager steps count from the same generator
state and leaves the generator where they leave it, on the fixed-T, early
stop, syndrome stop, SP and random-codeword paths; neither the steps nor a
replay synchronise with the host; a new sigma, parameter set or generator
captures a new graph.  The mesh's host read under an NCCL world of one: its
summed counters equal the replay's (==) at K = 1 and 4, it does not
synchronise, and a point on a new generator captures a new graph.  The
decoder's API: all-zero labels bit-equal to none through B1, B2 and B3,
labels of the wrong shape raising before any launch; real codewords (the
port's `Encoder` on the card) as labels through B1, B2, B3, B1-SP and the
SP early stop and syndrome stop, one launch each, counters integer-equal to
the plain version (SP on at least 99.9% of words), APPs as above;
`track_syndrome` through B1 and B1-SP, its flags bool-equal to the plain
version's (SP on 99.9% of words); `apply`'s default 'apps' through B4, and
under a systematic target its `app_last`: the last APP's rows past the
target from B4 and their cotangent through B5, against autograd through
the plain version at the training tolerances.  The channel
sampler's kernel (S1): its LLRs bit-equal to the plain version's as int32
views (signs of zero included, grid ties among them) for every decoding
type and grid, the zero word, codewords and the fold, one sigma and mixed
lanes, at 65536 and at a batch that is not a multiple of 4; one launch per
`sample` call and no other kernel but `randn`; a replay counting its K
launches.
"""

import pytest
import torch

from ldpc_error_floor_tpu_torch.channel import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.models import DecoderConfig, NMSDecoder, WeightSpec
from ldpc_error_floor_tpu_torch.ops.fused_decoder import (DEPLOY, EARLY_STOP, FIXED,
                                                          FusedNMSKernel)
from ldpc_error_floor_tpu_torch.ops.fused_train import FusedTrainKernel
from ldpc_error_floor_tpu_torch.training.losses import multi_iteration_loss

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"
WIFI = "802_11n_N648_R56_z27"
MACKAY = "MACKAY_N96_K48"
BCH = "BCH_63_51"

# (code, sharing, decoding_type, neural_mode, target_node)
CASES = [
    (WMAN, (3, 3, 3), 2, "scale", 0),
    (WMAN, (2, 2, 2), 1, "scale", 0),
    (WMAN, (1, 0, 0), 3, "scale", 0),
    (WMAN, (4, 4, 5), 2, "offset", 0),
    (MACKAY, (3, 3, 3), 2, "scale", 0),
    (G5, (2, 2, 2), 2, "scale", 10),
    (WIFI, (3, 0, 3), 2, "scale", 0),
]

# (code, sharing, decoding_type, SNR dB): at these SNRs some blocks stop
# early and some words fail
STOP_CASES = [
    (WMAN, (3, 3, 3), 2, 3.5),
    (MACKAY, (3, 0, 3), 1, 3.5),
    (WIFI, (3, 0, 3), 2, 4.0),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _setup(dev, code_name, sharing, dec, snr, T=6, B=1000, mode="scale",
           target=0, early_stop=False, seed=3, q_bit=5):
    code = get_code(code_name)
    graph = TannerGraph(code)
    temporal = any(s in (4, 5) for s in sharing)
    spec = WeightSpec(sharing=sharing, n_iters=T, fixed_iter=2 if temporal else 0)
    cfg = DecoderConfig(decoding_type=dec, neural_mode=mode, target_node=target,
                        early_stop=early_stop, q_bit=q_bit)
    kern = FusedNMSKernel(graph, cfg, spec)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = 0.0 if mode == "offset" else 0.7
    stacked = {k: None if spec.dim(k, graph) == 0 else
               (lo + 0.6 * torch.rand((T, spec.dim(k, graph)), generator=gen,
                                      device=dev)).contiguous()
               for k in ("cn", "ucn", "vn")}
    sig = torch.full((B,), float(code.snr_sigmas([snr])[0]), device=dev)
    llr = AWGNChannel(code, decoding_type=dec, q_bit=q_bit, device=dev).sample(gen, sig)
    return kern, stacked, llr


def _assert_app(app, app_p, dec):
    if dec == 2:
        assert bool((app == app_p).all())
        assert torch.equal(torch.signbit(app), torch.signbit(app_p))
    else:
        torch.testing.assert_close(app, app_p, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}_{c[3]}")
def test_kernel_matches_plain_on_card(case):
    dev = _cuda()
    code_name, sharing, dec, mode, target = case
    kern, stacked, llr = _setup(dev, code_name, sharing, dec, 2.5, mode=mode,
                                target=target)
    app, err, nerr = kern.decode_stats(stacked, llr)
    app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_stats": 1}
    assert torch.equal(err, err_p) and torch.equal(nerr, nerr_p)
    _assert_app(app, app_p, dec)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STOP_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}")
def test_early_stop_matches_grouped_plain_on_card(case):
    dev = _cuda()
    code_name, sharing, dec, snr = case
    kern, stacked, llr = _setup(dev, code_name, sharing, dec, snr, T=8,
                                early_stop=True)
    app, err, nerr = kern.decode_stats(stacked, llr)
    app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
    fixed = FusedNMSKernel(kern.graph, DecoderConfig(decoding_type=dec), kern.spec)
    app_f, err_f, _ = fixed.decode_stats(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_early_stop": 1}
    assert torch.equal(err, err_p) and torch.equal(nerr, nerr_p)
    _assert_app(app, app_p, dec)
    uncor = err.all(dim=0)
    assert torch.equal(uncor, err_f.all(dim=0))
    assert 0 < int(uncor.sum()) < uncor.numel()
    assert bool((app != app_f).any())  # some blocks did stop early


# (decoding type, q_bit): every QMS grid (codes in units of 0.5, 1 and 2;
# q_bit 6 rounds at two units) and MS (float state)
GRID_CASES = [(2, 3), (2, 4), (2, 5), (2, 6), (2, -5), (1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: f"dec{c[0]}_q{c[1]}")
def test_fixed_and_early_stop_every_grid_on_card(case):
    """B1 and B2 on wman (3,3,3) with UCN against the plain version on every
    QMS grid (the code state) and on MS (the float state): batches of 1001
    and 20001 words, no multiple of G, the first filling under a tenth of
    the card; B2 also at 5.0 dB, where most blocks stop within a few
    iterations."""
    dev = _cuda()
    dec, q_bit = case
    for B, snr, T in ((1001, 3.0, 8), (20001, 4.0, 10), (20001, 5.0, 10)):
        for es in (False, True):
            if snr == 5.0 and not es:
                continue
            kern, stacked, llr = _setup(dev, WMAN, (3, 3, 3), dec, snr, T=T, B=B,
                                        early_stop=es, q_bit=q_bit)
            app, err, nerr = kern.decode_stats(stacked, llr)
            app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
            torch.cuda.synchronize()
            assert kern.launches == {"fused_nms_early_stop" if es else "fused_nms_stats": 1}
            assert B % kern.launch_shape(EARLY_STOP if es else FIXED)[0]
            assert torch.equal(err, err_p) and torch.equal(nerr, nerr_p)
            _assert_app(app, app_p, dec)
            if es and snr == 5.0:  # most stops within a few iterations
                G = kern.group  # 1 under QMS: each word's own stop
                still = torch.cumprod(err.int(), dim=0).bool()
                still = torch.cat([still, still.new_zeros((T, -B % G))], dim=1)
                iters = 1 + still.view(T, -1, G).any(dim=2)[:-1].sum(dim=0)
                assert float(iters.float().mean()) < T / 2


G5_64 = "5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640"
# (code, sharing, T, target_node, SNR dB where most words stop early): B2,
# the code state's genie stop per word, on the benchmark's two codes
WORD_STOP_CASES = [
    (WMAN, (3, 3, 3), 10, 0, 5.0),
    (G5_64, (2, 2, 2), 12, 10, 3.0),
]


def _own_iterations(err):
    """[B] each word's own iterations to its genie stop (its first correct
    iteration plus one; T for a word wrong at every iteration), from its
    flags [T, B]."""
    still = torch.cumprod(err.int(), dim=0).bool()
    return 1 + still[:-1].sum(dim=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WORD_STOP_CASES, ids=lambda c: c[0][:6])
def test_word_stop_equals_plain_at_group_one_on_card(case):
    """B2 on wman (3,3,3) with UCN and 5G z 64 (2,2,2) under a
    systematic target: 1001 words (fewer than the card's lanes), 20001 at
    the SNR where most words stop within a few iterations (the lanes take
    new words across many tiles) and 1001 random codewords as labels, each
    in one launch, bit-equal to `decode_stats_plain(group=1)`: counters,
    the APP of each word's own stop with its signs, the rows after it 0;
    also on LLRs off the QMS grid and signed zeros, which the kernel does
    not keep as codes."""
    dev = _cuda()
    code_name, sharing, T, target, snr = case
    for B, snr_b, kind in ((1001, 2.5, "zero"), (20001, snr, "zero"), (1001, snr, "labels"),
                           (1001, snr, "off_grid")):
        kern, stacked, llr = _setup(dev, code_name, sharing, 2, snr_b, T=T, B=B,
                                    target=target, early_stop=True)
        assert kern.group == 1
        labels = None
        if kind == "labels":
            bits, llr = _codewords(dev, kern, snr_b, B)
            labels = bits[: kern.target * kern.z]
        if kind == "off_grid":  # LLRs off the QMS grid, and signed zeros
            llr[:, ::3] *= 1.013
            llr[::5, 1::4] = -0.0
            llr[::7, 2::4] = 0.0
        out = kern.decode_stats(stacked, llr, labels)
        ref = kern.decode_stats_plain(stacked, llr, group=1, labels=labels)
        torch.cuda.synchronize()
        assert kern.launches == {"fused_nms_early_stop": 1}
        for x, y in zip(out[1:], ref[1:]):
            assert x.dtype == y.dtype and torch.equal(x, y)
        _assert_app(out[0], ref[0], 2)
        own = _own_iterations(out[1])
        rows = torch.arange(T, device=dev)[:, None]
        assert not bool(out[1][rows >= own[None]].any())
        assert int(own.min()) < T and (B == 1001 or float(own.float().mean()) < 0.75 * T)


# (code, sharing, T, target_node, weights, SNR dB): B2 over a host read, on
# the benchmark's two configurations
READ_CASES = [
    (WMAN, (3, 3, 3), 20, 0, f"{WMAN}_base20", 5.5),
    (G5_64, (2, 2, 2), 50, 10, f"{G5_64}_iter50", 3.0),
]


def _read_setup(dev, case):
    """B2's wrapper, its stacked weights and a sampler of reads [K, N*z, B]
    in which every 97th word is made wrong at every iteration (its LLRs
    made positive: bit 1 everywhere)."""
    from ldpc_error_floor_tpu_torch.models import load_params, stack_weights
    code_name, sharing, T, target, weights, snr = case
    code = get_code(code_name)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=sharing, n_iters=T)
    kern = FusedNMSKernel(graph, DecoderConfig(target_node=target, early_stop=True), spec)
    stacked = stack_weights(spec, load_params(spec, graph, weights, device=dev))
    ch = AWGNChannel(code, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    sigma = float(code.snr_sigmas([snr])[0])

    def read(K, B):
        llr = torch.empty((K, code.n_full, B), device=dev)
        for k in range(K):
            ch.sample(gen, torch.full((B,), sigma, device=dev), out=llr[k])
        llr[:, :, 5::97] = llr[:, :, 5::97].abs()
        return llr
    return kern, stacked, read


@pytest.mark.cuda
@pytest.mark.parametrize("case", READ_CASES, ids=lambda c: c[0][:6])
def test_read_totals_equal_batch_rows_on_card(case):
    """B2 over a host read [K, N*z, B] in one launch, its totals int64
    [bit errors and frames wrong at the last iteration, frames wrong at
    every iteration], equal the reductions of the rows of K launches of one
    batch each on the same LLRs, at K = 3 and B = 4096, and at K = 1 with a
    batch that is no multiple of G (one ragged tile), and at K = 2 with that
    batch (tiles that straddle two batches); two reads in a row give the
    same (the claim counter set back by each launch's last block)."""
    dev = _cuda()
    kern, stacked, read = _read_setup(dev, case)
    assert 1001 % kern.launch_shape(EARLY_STOP)[0]
    for K, B in ((3, 4096), (1, 1001), (2, 1001)):
        llr = read(K, B)
        want = kern.read_totals_of_rows(stacked, llr)
        kern.launches.clear()
        got = [kern.decode_read_totals(stacked, llr) for _ in range(2)]
        torch.cuda.synchronize()
        assert kern.launches == {"fused_nms_early_stop": 2}
        assert all(g.dtype == torch.int64 and g.tolist() == want.tolist() for g in got)
        assert int(want[2]) >= K * (B // 97) and int(want[1]) == int(want[2])


@pytest.mark.cuda
def test_read_counts_its_words_on_card(monkeypatch):
    """Under a profiler's flag B2 over a read of K batches adds K*B words
    to the engagement pair, and at least each word's step that finds it
    correct or at T."""
    from ldpc_error_floor_tpu_torch.utils import profiling
    dev = _cuda()
    kern, stacked, read = _read_setup(dev, READ_CASES[0])
    K, B = 3, 4096
    llr = read(K, B)
    profiling.reset()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    kern.decode_read_totals(stacked, llr)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    pair = profiling.snapshot()["fused_nms_early_stop"]
    assert pair["words"] == K * B and pair["lane_steps"] >= 2 * K * B
    profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_graph_chunk_runs_b2_once_on_card(K):
    """Under QMS with the early stop a replayed chunk runs B2 once over its
    K batches and the sampler K times, and its counters are B2's totals."""
    dev = _cuda()
    sim, params, sigma = _graph_sim(dev, GRAPH_PATHS[1], K)
    gen = torch.Generator(device=dev).manual_seed(5)
    for n in (1, 2):
        out = sim._chunk(params, gen, sigma)
        assert sim.decoder.kernel.launches == {"fused_nms_early_stop": n}
        assert sim.channel.launches == {"awgn_llr": n * K}
        assert out.dtype == torch.int64 and tuple(out.shape) == (3,)
    assert int(out[1]) == int(out[2]) > 0


@pytest.mark.cuda
def test_word_stop_counts_lane_steps_on_card(monkeypatch):
    """Under a profiler's flag B2 adds its words and lane-steps to the
    engagement pair that `utils.profiling.snapshot()` reads: words equal
    to B; lane-steps at least each word's own iterations plus one (the step
    that finds it correct, or the T-th step's statistics) and at most that
    plus T + 2 steps of every lane the launch holds (a lane idles at the
    launch's end from the step after its last word's stop, at most until
    the slowest word of its block is written).  With no profiler nothing is
    counted."""
    from ldpc_error_floor_tpu_torch.utils import profiling
    dev = _cuda()
    T, B = 10, 20001
    kern, stacked, llr = _setup(dev, WMAN, (3, 3, 3), 2, 5.0, T=T, B=B, early_stop=True)
    profiling.reset()
    kern.decode_stats(stacked, llr)
    assert "fused_nms_early_stop" not in profiling.snapshot()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    err = kern.decode_stats(stacked, llr)[1]
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    pair = profiling.snapshot()["fused_nms_early_stop"]
    G = kern.launch_shape(EARLY_STOP)[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = min(-(-B // G), kern.resident_blocks(EARLY_STOP) * sms) * G
    least = int((_own_iterations(err) + 1).sum())
    assert pair["words"] == B
    assert least <= pair["lane_steps"] <= least + lanes * (T + 2)
    profiling.reset()
    assert "fused_nms_early_stop" not in profiling.snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("case", STOP_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}")
def test_deploy_matches_plain_on_card(case):
    dev = _cuda()
    code_name, sharing, dec, snr = case
    T = 8
    kern, stacked, llr = _setup(dev, code_name, sharing, dec, snr, T=T)
    out = kern.decode_deploy(stacked, llr)
    ref = kern.decode_deploy_plain(stacked, llr)
    _, err, nerr = kern.decode_stats(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_deploy": 1, "fused_nms_stats": 1}
    app, wrong, nerr_d, iters, fail = out
    for x, y in zip(out[1:], ref[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    _assert_app(app, ref[0], dec)
    assert 1 <= int(iters.min()) and int(iters.max()) <= T
    assert int(iters.min()) < T and bool(fail.any())
    # against the stats kernel on the same LLRs
    idx = (iters.long() - 1)[None]
    assert torch.equal(wrong, err.gather(0, idx)[0])
    assert torch.equal(nerr_d, nerr.gather(0, idx)[0])
    assert not bool((err.all(dim=0) & ~wrong).any())  # genie failures ⊆ wrong
    assert not bool((fail & ~wrong).any())            # detected_fail ⇒ wrong


@pytest.mark.cuda
@pytest.mark.parametrize("code_name,sharing", [(WMAN, (3, 0, 3)), (MACKAY, (2, 2, 2)),
                                               (WIFI, (0, 0, 0))])
def test_sp_matches_plain_on_card(code_name, sharing):
    dev = _cuda()
    kern, stacked, llr = _setup(dev, code_name, sharing, 0, 2.5, T=5, B=4000)
    app, err, nerr = kern.decode_stats(stacked, llr)
    app_p, err_p, nerr_p = kern.decode_stats_plain(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_stats_sp": 1}
    torch.testing.assert_close(app, app_p, rtol=1e-4, atol=1e-3)
    words_off = ((err != err_p) | (nerr != nerr_p)).any(dim=0).sum().item()
    assert words_off <= 0.001 * llr.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 1001])
@pytest.mark.parametrize("code_name,sharing", [
    (WMAN, (3, 3, 3)), (WIFI, (3, 0, 3)), ("Polar_64_48", (3, 0, 3)),
    ("5G_LDPC_R0.73_n_dec2304_n2112_k1536_z72_s1537_1584", (3, 0, 3))])
def test_sp_every_mode_ragged_batch_on_card(code_name, sharing, B):
    """B1-SP, the SP early stop and the SP syndrome stop at 4.0 dB (some
    blocks stop early, some words fail) on a batch that is not a multiple
    of their G (802.11n and Polar: check degrees 22 and 64, past the first
    chunk of slots whose suffix products stay in registers; 5G at z = 72:
    one block of 768 threads per SM), against the plain version
    (APPs within atol 1e-3 / rtol 1e-4, counters equal on at least 99.9% of
    words) and, exactly, against each other: the early stop's rows up to
    its block's stop and the syndrome stop's row iters-1 are the fixed-T
    kernel's."""
    dev = _cuda()
    T = 6
    kern, stacked, llr = _setup(dev, code_name, sharing, 0, 4.0, T=T, B=B)
    es = FusedNMSKernel(kern.graph, DecoderConfig(decoding_type=0, early_stop=True),
                        kern.spec)
    assert all(B % k.launch_shape(m)[0] for k, m in ((kern, FIXED), (es, EARLY_STOP),
                                                      (kern, DEPLOY)))
    app, err, nerr = kern.decode_stats(stacked, llr)
    app_e, err_e, nerr_e = es.decode_stats(stacked, llr)
    out_d = kern.decode_deploy(stacked, llr)
    ref = kern.decode_stats_plain(stacked, llr, early_stop=False)
    ref_e = es.decode_stats_plain(stacked, llr)
    ref_d = kern.decode_deploy_plain(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_stats_sp": 1, "fused_nms_deploy_sp": 1}
    assert es.launches == {"fused_nms_early_stop_sp": 1}
    limit = 0.001 * B
    torch.testing.assert_close(app, ref[0], rtol=1e-4, atol=1e-3)
    assert ((err != ref[1]) | (nerr != ref[2])).any(dim=0).sum().item() <= limit
    off_e = ((err_e != ref_e[1]) | (nerr_e != ref_e[2])).any(dim=0)
    assert off_e.sum().item() <= limit
    torch.testing.assert_close(app_e[:, ~off_e], ref_e[0][:, ~off_e], rtol=1e-4, atol=1e-3)
    off_d = torch.zeros(B, dtype=torch.bool, device=dev)
    for x, y in zip(out_d[1:], ref_d[1:]):
        off_d |= x != y
    assert off_d.sum().item() <= limit
    torch.testing.assert_close(out_d[0][:, ~off_d], ref_d[0][:, ~off_d], rtol=1e-4, atol=1e-3)
    # the kernels against each other, exactly
    # a block of G words runs until each of its words has decoded once
    G = es.launch_shape(EARLY_STOP)[0]
    still = torch.cumprod(err.int(), dim=0).bool()
    still = torch.cat([still, still.new_zeros((T, -B % G))], dim=1)
    n_run = (1 + still.view(T, -1, G).any(dim=2)[:-1].sum(dim=0)).repeat_interleave(G)[:B]
    running = torch.arange(T, device=dev)[:, None] < n_run[None]
    assert torch.equal(err_e[running], err[running])
    assert torch.equal(nerr_e[running], nerr[running])
    assert not bool(err_e[~running].any()) and not bool(nerr_e[~running].any())
    assert torch.equal(err_e.all(dim=0), err.all(dim=0))
    app_d, wrong, nerr_d, iters, fail = out_d
    idx = (iters.long() - 1)[None]
    assert torch.equal(wrong, err.gather(0, idx)[0])
    assert torch.equal(nerr_d, nerr.gather(0, idx)[0])
    assert not bool((fail & ~wrong).any())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 1001])
def test_deploy_own_launch_shape_ragged_batch_on_card(B):
    """B3 at its own G (`kDeployBlocks`, fewer words than the fixed-T
    kernel's) on a batch that is not a multiple of it: every output equal
    to the plain version, APPs bit-equal with their signs."""
    dev = _cuda()
    kern, stacked, llr = _setup(dev, WMAN, (3, 3, 3), 2, 3.5, T=8, B=B)
    G = kern.launch_shape(DEPLOY)[0]
    assert B % G and G < kern.launch_shape(FIXED)[0]
    out = kern.decode_deploy(stacked, llr)
    ref = kern.decode_deploy_plain(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_deploy": 1}
    for x, y in zip(out[1:], ref[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    _assert_app(out[0], ref[0], 2)
    if B > G:
        assert 1 <= int(out[3].min()) < int(out[3].max())


@pytest.mark.cuda
def test_kernel_rejects_sp_and_bad_inputs_on_card():
    dev = _cuda()
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 0, 3), n_iters=2)
    llr = torch.zeros((code.n_full, 8), device=dev)
    w = {"cn": torch.ones((2, 1), device=dev), "ucn": None,
         "vn": torch.ones((2, 1), device=dev)}
    kern = FusedNMSKernel(graph, DecoderConfig(), spec)
    with pytest.raises(ValueError, match="llr"):
        kern.decode_stats(w, llr[:, ::2])
    with pytest.raises(ValueError, match="llr"):
        kern.decode_deploy(w, llr.double())
    with pytest.raises(ValueError, match="cn weights"):
        kern.decode_stats({**w, "cn": torch.ones((3, 1), device=dev)}, llr)
    assert not kern.launches


# (decoder config, collect, the kernel it launches)
API_PATHS = [
    ({}, "stats", "fused_nms_stats"),
    ({"early_stop": True}, "stats", "fused_nms_early_stop"),
    ({}, "deploy", "fused_nms_deploy"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("path", API_PATHS, ids=lambda p: p[2])
def test_decoder_labels_on_card(path):
    """`NMSDecoder.decode` on the card: all-zero labels (float and bool) run
    the kernel once and give outputs bit-equal to no labels; labels with a
    bit set run it once too, counting against them as the plain version
    does; labels of the wrong shape raise before any launch."""
    dev = _cuda()
    overrides, collect, name = path
    kern, stacked, llr = _setup(dev, WMAN, (3, 3, 3), 2, 3.5, T=8, B=1001)
    dec = NMSDecoder(kern.graph.code, DecoderConfig(**overrides), kern.spec,
                     graph=kern.graph, device=dev)
    ref = dec.decode(stacked, llr, collect=collect)
    zeros = torch.zeros((dec.target * dec.z, llr.shape[1]), device=dev)
    for labels in (zeros, zeros.bool()):
        dec.kernel.launches.clear()
        out = dec.decode(stacked, llr, labels=labels, collect=collect)
        torch.cuda.synchronize()
        assert dec.kernel.launches == {name: 1}
        for x, y in zip(out, ref):
            assert (x is None and y is None) or (
                x.device.type == "cuda" and x.dtype == y.dtype and torch.equal(x, y))
        assert torch.equal(torch.signbit(out[0]), torch.signbit(ref[0]))
    one_bit = zeros.clone()
    one_bit[5, 7] = 1.0
    dec.kernel.launches.clear()
    out = dec.decode(stacked, llr, labels=one_bit, collect=collect)
    ref = (dec.kernel.decode_deploy_plain(stacked, llr, labels=one_bit) if collect == "deploy"
           else dec.kernel.decode_stats_plain(stacked, llr, labels=one_bit))
    torch.cuda.synchronize()
    assert dec.kernel.launches == {name: 1}
    for x, y in zip(out[1:], ref[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="labels of shape"):
        dec.decode(stacked, llr, labels=zeros[:-1], collect=collect)
    assert dec.kernel.launches == {name: 1}


@pytest.mark.cuda
def test_track_syndrome_and_apply_default_on_card():
    """A decoder for the card with `track_syndrome` runs the fixed-T kernel
    once and returns the syndrome flags, bool-equal to the plain version's,
    with the other outputs bit-equal to a decode without them;
    `apply(params, llr)` returns the APP stack through B4 alone, as JAX's
    default 'apps'."""
    dev = _cuda()
    kern, stacked, llr = _setup(dev, WMAN, (3, 3, 3), 2, 3.5, T=8, B=1001)
    code = kern.graph.code
    tracking = NMSDecoder(code, DecoderConfig(track_syndrome=True), kern.spec,
                          graph=kern.graph, device=dev)
    res = tracking.decode(stacked, llr)
    ref = tracking.kernel.decode_stats_plain(stacked, llr)
    plain_b1 = kern.decode_stats(stacked, llr)
    torch.cuda.synchronize()
    assert tracking.kernel.launches == {"fused_nms_stats": 1}
    assert res.syndrome_ok.shape == (8, 1001) and torch.equal(res.syndrome_ok, ref[3])
    assert 0 < int(res.syndrome_ok[-1].sum()) < 1001
    assert all(torch.equal(x, y) for x, y in zip(res[:3], plain_b1))
    kern.launches.clear()
    dec = NMSDecoder(code, DecoderConfig(), kern.spec, graph=kern.graph, device=dev)
    res = dec.apply(stacked, llr)
    app_b1 = kern.decode_stats(stacked, llr)[0]
    torch.cuda.synchronize()
    assert res.err_flags is None and res.apps.shape == (8, code.n_full, 1001)
    assert dec.train_kernel.launches == {dec.train_kernel.fwd_name: 1}
    assert not dec.kernel.launches
    assert torch.equal(res.apps[-1], app_b1)  # B4 and B1 run one loop: QMS bit-equal


def _codewords(dev, kern, snr, B, seed=7):
    """(random codewords [n_full, B] from the port's `Encoder` on the card,
    their LLRs at `snr` dB: BPSK of the encoded word, no fold)."""
    from ldpc_error_floor_tpu_torch.codes import Encoder
    code = kern.graph.code
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = Encoder(kern.graph, device=dev).random_codewords(gen, B)
    sig = torch.full((B,), float(code.snr_sigmas([snr])[0]), device=dev)
    ch = AWGNChannel(code, decoding_type=kern.cfg.decoding_type, device=dev)
    return bits, ch.sample_codewords(gen, sig, bits, fold=False)


# (code, sharing, decoding type, SNR dB, target_node): codewords through the
# labelled instances; at these SNRs some blocks stop early and some words fail
LABEL_CASES = [
    (WMAN, (3, 3, 3), 2, 3.5, 0),   # the code state with UCN
    (WMAN, (3, 0, 3), 2, 3.5, 18),  # a systematic target
    (MACKAY, (3, 0, 3), 1, 3.5, 0),  # the float state
    (WMAN, (3, 0, 3), 0, 3.5, 0),   # SP
    (WIFI, (3, 0, 3), 0, 4.0, 0),   # SP past one chunk of 16 slots
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LABEL_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}_t{c[4]}")
def test_codeword_labels_through_every_decode_kernel_on_card(case):
    """Real codewords as labels through the fixed T, the genie early stop
    and the syndrome stop on 1001 words (no multiple of G), one launch
    each: counters integer-equal to the plain version on the card (the
    early stop grouped as the kernel groups words; SP on at least 99.9% of
    words), APPs as the zero word's tests hold them; the genie-failure
    masks of the fixed T and the early stop equal, and some words right
    and some wrong against their codewords."""
    dev = _cuda()
    code_name, sharing, dec, snr, target = case
    kern, stacked, _ = _setup(dev, code_name, sharing, dec, snr, T=8, B=8, target=target)
    bits, llr = _codewords(dev, kern, snr, 1001)
    labels = bits[: kern.target * kern.z]
    es = FusedNMSKernel(kern.graph, DecoderConfig(decoding_type=dec, early_stop=True,
                                                  target_node=target), kern.spec)
    outs = {"fixed": kern.decode_stats(stacked, llr, labels),
            "early_stop": es.decode_stats(stacked, llr, labels),
            "deploy": kern.decode_deploy(stacked, llr, labels)}
    refs = {"fixed": kern.decode_stats_plain(stacked, llr, labels=labels),
            "early_stop": es.decode_stats_plain(stacked, llr, labels=labels),
            "deploy": kern.decode_deploy_plain(stacked, llr, labels=labels)}
    torch.cuda.synchronize()
    sfx = "_sp" if dec == 0 else ""
    assert kern.launches == {"fused_nms_stats" + sfx: 1, "fused_nms_deploy" + sfx: 1}
    assert es.launches == {"fused_nms_early_stop" + sfx: 1}
    for name, out in outs.items():
        ref = refs[name]
        off = torch.zeros(1001, dtype=torch.bool, device=dev)
        for x, y in zip(out[1:], ref[1:]):
            assert x.dtype == y.dtype
            off |= (x != y).reshape(-1, 1001).any(dim=0)
        if dec == 0:
            assert off.sum().item() <= 1, name
            torch.testing.assert_close(out[0][:, ~off], ref[0][:, ~off], rtol=1e-4, atol=1e-3)
        else:
            assert not bool(off.any()), name
            _assert_app(out[0], ref[0], dec)
    uncor = outs["fixed"][1].all(dim=0)
    assert torch.equal(outs["early_stop"][1].all(dim=0), uncor)
    assert 0 < int(uncor.sum()) < 1001 and bool(outs["deploy"][1].any())


# (code, sharing, decoding type, SNR dB): track_syndrome at a fixed T
TRACK_CASES = [
    (WMAN, (3, 3, 3), 2, 3.5),   # the code state, UCN's parity
    (WMAN, (3, 0, 3), 2, 3.5),   # the code state without UCN
    (MACKAY, (3, 0, 3), 1, 3.5),  # the float state: parity bits of its own
    (WMAN, (2, 2, 2), 0, 3.5),   # SP with UCN
    (WIFI, (3, 0, 3), 0, 4.0),   # SP without UCN
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRACK_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}")
def test_track_syndrome_matches_plain_on_card(case):
    """`track_syndrome` through B1 and B1-SP on 1001 words, with and
    without codeword labels: the flags [T, B] bool-equal to the plain
    version's (SP on 99.9% of words), the other outputs bit-equal to the
    decode without them, and against the syndrome stop on the same LLRs:
    a word's flags hold at some iteration exactly when it has no
    detected_fail, first at its iters - 1."""
    dev = _cuda()
    code_name, sharing, dec, snr = case
    kern, stacked, llr = _setup(dev, code_name, sharing, dec, snr, T=8, B=1001)
    tk = FusedNMSKernel(kern.graph, DecoderConfig(decoding_type=dec, track_syndrome=True),
                        kern.spec)
    bits, llr_cw = _codewords(dev, kern, snr, 1001)
    for x, lab in ((llr, None), (llr_cw, bits[: kern.target * kern.z])):
        out = tk.decode_stats(stacked, x, lab)
        ref = tk.decode_stats_plain(stacked, x, labels=lab)
        b1 = kern.decode_stats(stacked, x, lab)
        _, _, _, iters, fail = kern.decode_deploy(stacked, x, lab)
        torch.cuda.synchronize()
        assert len(out) == 4 and out[3].dtype == torch.bool and out[3].shape == (8, 1001)
        off = (out[3] != ref[3]).any(dim=0)
        assert off.sum().item() <= (1 if dec == 0 else 0)
        assert all(torch.equal(p, q) for p, q in zip(out[:3], b1))
        held = out[3].any(dim=0)
        assert torch.equal(held, ~fail)
        first = out[3].int().argmax(dim=0) + 1
        assert torch.equal(iters[held], first[held].int())
        assert 0 < int(out[3][-1].sum()) < 1001
    assert tk.launches == {"fused_nms_stats" + ("_sp" if dec == 0 else ""): 2}


# (code, sharing, decoding type, target_node): app_last under a systematic target
APP_LAST_CASES = [
    (G5, (2, 2, 2), 2, 10),
    (WMAN, (3, 3, 3), 1, 18),
    (MACKAY, (3, 0, 3), 0, 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", APP_LAST_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}")
def test_app_last_under_a_systematic_target_on_card(case):
    """`apply(params, llr)` under ``target_node > 0`` on the card: `app_last`
    [N*z, B] from B4 (its rows past the target from the kExtra instance),
    equal to the plain version's (QMS bit-equal, MS within atol 1e-5, SP
    within atol 1e-3 / rtol 1e-4), its target rows `apps[-1]`; the gradient
    of ``sum(app_last * r)`` through B5 against autograd through the plain
    version within rtol 1e-4 and atol 1e-5 x max|g|, two launches
    bit-identical."""
    dev = _cuda()
    code_name, sharing, dec, target = case
    tcase = (code_name, sharing, dec, 4, 2, 0.5, "scale", target)
    kern, stacked, llr = _train_setup(dev, tcase, B=1001)
    dec_t = NMSDecoder(kern.graph.code, kern.cfg, kern.spec, graph=kern.graph, device=dev)
    r = torch.randn(llr.shape, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    runs = []
    for route in ("kernel", "kernel", "plain"):
        ws = {k: None if v is None else v.clone().requires_grad_(True)
              for k, v in stacked.items()}
        if route == "kernel":
            res = dec_t.apply(ws, llr)
            apps, last = res.apps, res.app_last
        else:
            apps, last = dec_t.train_kernel.apps_and_last_plain(ws, llr)
        (last * r).sum().backward()
        runs.append((apps.detach(), last.detach(),
                     {k: v.grad for k, v in ws.items() if v is not None}))
    torch.cuda.synchronize()
    tk = dec_t.train_kernel
    assert tk.launches == {tk.fwd_name: 2, tk.bwd_name: 2}
    (apps, last, g1), (_, _, g2), (apps_p, last_p, g_p) = runs
    assert last.shape == (kern.N * kern.z, 1001) and torch.equal(last[: apps.shape[1]], apps[-1])
    _assert_train_apps(last, last_p, dec)
    _assert_train_apps(apps, apps_p, dec)
    for k, g_ref in g_p.items():
        assert torch.equal(g1[k], g2[k])
        scale = max(float(g_ref.abs().max()), 1e-8)
        torch.testing.assert_close(g1[k], g_ref, rtol=1e-4, atol=1e-5 * scale)
        assert float(g1[k].abs().max()) > 0.0


# (code, sharing, decoding_type, T, loss_type, etha, neural_mode, target_node):
# the CPU gradient-parity cases (tests/test_torch_train_grad.py) at T <= 6
TRAIN_CASES = [
    (WMAN, (3, 0, 3), 2, 4, 2, 0.5, "scale", 0),
    (WMAN, (3, 3, 3), 2, 6, 2, 0.0, "scale", 0),
    (WMAN, (5, 0, 5), 2, 4, 1, 0.8, "scale", 0),
    (WMAN, (1, 1, 0), 2, 3, 0, 1.0, "scale", 0),
    (WMAN, (2, 2, 2), 1, 4, 2, 0.5, "scale", 0),
    (WMAN, (3, 0, 3), 2, 4, 2, 0.5, "offset", 0),
    (G5, (2, 2, 2), 2, 3, 2, 0.5, "scale", 10),
    (MACKAY, (3, 0, 3), 3, 4, 2, 0.5, "scale", 0),
    (WMAN, (3, 0, 3), 0, 4, 2, 0.5, "scale", 0),
    (WMAN, (2, 2, 2), 0, 3, 1, 0.8, "scale", 0),
    (WMAN, (1, 1, 0), 0, 3, 0, 1.0, "scale", 0),
    (MACKAY, (3, 3, 3), 0, 4, 2, 0.5, "scale", 0),
    # B5-SP's weight sums (per-VN rows in gv; scalar and per-check sums in
    # registers) and its checks past one chunk of 16 slots
    (WMAN, (5, 0, 5), 0, 4, 2, 0.5, "scale", 0),
    (MACKAY, (3, 0, 3), 0, 4, 2, 0.5, "offset", 0),  # wman's SP messages die under offsets
    (WIFI, (3, 0, 3), 0, 3, 2, 0.5, "scale", 0),
    (BCH, (2, 2, 2), 0, 3, 1, 0.8, "scale", 0),
    (BCH, (1, 1, 0), 0, 3, 2, 0.5, "scale", 0),
]
SP_TRAIN_CASES = [c for c in TRAIN_CASES if c[2] == 0]


def _train_setup(dev, case, B=1000, app_t0=0, seed=5):
    code_name, sharing, dec, T, _, _, mode, target = case
    code = get_code(code_name)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=sharing, n_iters=T)
    cfg = DecoderConfig(decoding_type=dec, neural_mode=mode, target_node=target,
                        app_t0=app_t0)
    kern = FusedTrainKernel(graph, cfg, spec)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = 0.0 if mode == "offset" else 0.7
    stacked = {k: None if spec.dim(k, graph) == 0 else
               (lo + 0.6 * torch.rand((T, spec.dim(k, graph)), generator=gen,
                                      device=dev)).contiguous()
               for k in ("cn", "ucn", "vn")}
    sig = torch.full((B,), float(code.snr_sigmas([2.5])[0]), device=dev)
    llr = AWGNChannel(code, decoding_type=dec, device=dev).sample(gen, sig)
    return kern, stacked, llr


def _assert_train_apps(apps, ref, dec):
    assert apps.shape == ref.shape
    if dec == 2:
        assert bool((apps == ref).all())
    elif dec == 0:
        torch.testing.assert_close(apps, ref, rtol=1e-4, atol=1e-3)
    else:
        torch.testing.assert_close(apps, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}_{c[6]}")
def test_train_forward_matches_plain_on_card(case):
    """B4 under no_grad (the APPs alone, the evaluator's launch) against the
    plain forward, and the launch that also streams the residuals
    (training's) against it bit for bit."""
    dev = _cuda()
    T = case[3]
    for t0 in (0, T - 1):
        kern, stacked, llr = _train_setup(dev, case, app_t0=t0)
        with torch.no_grad():
            apps = kern.apps(stacked, llr)
        ref = kern.apps_plain(stacked, llr)
        ws = {k: None if v is None else v.clone().requires_grad_(True)
              for k, v in stacked.items()}
        streamed = kern.apps(ws, llr)
        torch.cuda.synchronize()
        assert kern.launches == {kern.fwd_name: 2}
        assert apps.shape[0] == T - t0
        _assert_train_apps(apps, ref, case[2])
        assert streamed.requires_grad and torch.equal(streamed.detach(), apps)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}_{c[6]}")
def test_train_backward_matches_autograd_on_card(case):
    dev = _cuda()
    loss_type, etha = case[4], case[5]
    t0 = case[3] - 1 if etha == 0.0 else 0
    kern, stacked, llr = _train_setup(dev, case, app_t0=t0)
    labels = torch.zeros((kern.target * kern.z, llr.shape[1]), device=dev)
    grads = []
    for run in ("kernel", "kernel", "plain"):
        ws = {k: None if v is None else v.clone().requires_grad_(True)
              for k, v in stacked.items()}
        apps = kern.apps(ws, llr) if run == "kernel" else kern.apps_plain(ws, llr)
        loss = multi_iteration_loss(apps, labels, loss_type, etha)
        loss.backward()
        grads.append({k: v.grad for k, v in ws.items() if v is not None})
    torch.cuda.synchronize()
    assert kern.launches == {kern.fwd_name: 2, kern.bwd_name: 2}
    for k, g_ref in grads[2].items():
        assert torch.equal(grads[0][k], grads[1][k])  # deterministic
        scale = max(float(g_ref.abs().max()), 1e-8)
        torch.testing.assert_close(grads[0][k], g_ref, rtol=1e-4, atol=1e-5 * scale)
        assert float(grads[0][k].abs().max()) > 0.0


def _grads(kern, stacked, llr, loss_type, etha, plain=False):
    ws = {k: None if v is None else v.clone().requires_grad_(True)
          for k, v in stacked.items()}
    apps = kern.apps_plain(ws, llr) if plain else kern.apps(ws, llr)
    labels = torch.zeros((kern.target * kern.z, llr.shape[1]), device=llr.device)
    multi_iteration_loss(apps, labels, loss_type, etha).backward()
    return {k: v.grad for k, v in ws.items() if v is not None}


# ragged batches through the tile-major streams: scalar (register sums),
# scalar with UCN, per-edge (gw), per-check (per-item sums), and the SP pair
# (scalar, per-check with UCN, per-edge, 802.11n past one chunk)
RAGGED_CASES = [c for i, c in enumerate(TRAIN_CASES) if i in (0, 1, 3, 4, 8, 9, 10, 14)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}_{c[2]}")
def test_train_ragged_batch_on_card(case):
    """B not a multiple of the tile width W (B5's G) nor of 4: the last tile
    of the residual streams is padded, B4's APPs hold to the plain forward
    and B5's gradients to autograd through it, bit-identical over two
    launches."""
    dev = _cuda()
    loss_type, etha = case[4], case[5]
    for B in (3, 1001):
        kern, stacked, llr = _train_setup(dev, case, B=B, app_t0=0)
        W = kern.tile_width
        assert B % W and B % 4
        ws = {k: None if v is None else v.clone().requires_grad_(True)
              for k, v in stacked.items()}
        _, hist, cres = kern._forward((ws["cn"], ws["ucn"], ws["vn"]), llr, True)
        assert hist.shape == (-(-B // W), kern.T, kern.E * kern.z, W)
        with torch.no_grad():
            apps = kern.apps(stacked, llr)
        _assert_train_apps(apps, kern.apps_plain(stacked, llr), case[2])
        g1, g2 = (_grads(kern, stacked, llr, loss_type, etha) for _ in range(2))
        ref = _grads(kern, stacked, llr, loss_type, etha, plain=True)
        torch.cuda.synchronize()
        for k, g_ref in ref.items():
            assert torch.equal(g1[k], g2[k])
            scale = max(float(g_ref.abs().max()), 1e-8)
            torch.testing.assert_close(g1[k], g_ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SP_TRAIN_CASES, ids=lambda c: f"{c[0][:6]}_{c[1]}")
def test_sp_train_last_app_equals_b1_sp_on_card(case):
    """B4-SP is the decode loop's kTrain instance of B1-SP: at the last
    iteration its APP is B1-SP's, bit for bit, on the same LLRs."""
    dev = _cuda()
    kern, stacked, llr = _train_setup(dev, case, app_t0=case[3] - 1)
    with torch.no_grad():
        apps = kern.apps(stacked, llr)
    app, _, _ = FusedNMSKernel(kern.graph, kern.cfg, kern.spec).decode_stats(stacked, llr)
    torch.cuda.synchronize()
    assert kern.launches == {"fused_nms_train_fwd_sp": 1}
    assert torch.equal(apps[-1], app)


# The host loop's CUDA graph (`sim/fer.py`): (path, sharing, decoding type,
# early stop, stop mode, codewords, SNR dB) on wman at T = 6, B = 1000
GRAPH_PATHS = [
    ("fixed", (3, 3, 3), 2, False, "genie", "zero", 3.0),
    ("early_stop", (3, 3, 3), 2, True, "genie", "zero", 3.0),
    ("syndrome", (3, 3, 3), 2, False, "syndrome", "zero", 3.0),
    ("sp", (3, 0, 3), 0, False, "genie", "zero", 3.0),
    ("fixed_random_words", (3, 3, 3), 2, False, "genie", "random", 3.0),
]


def _graph_sim(dev, path, K, B=1000, mesh=None):
    from ldpc_error_floor_tpu_torch.models import NMSDecoder, init_weights
    from ldpc_error_floor_tpu_torch.sim import FERSimulator
    _, sharing, dec, early_stop, stop, words, snr = path
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=sharing, n_iters=6)
    decoder = NMSDecoder(code, DecoderConfig(decoding_type=dec, early_stop=early_stop),
                         spec, graph=graph, device=dev)
    params = init_weights(spec, graph, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = {k: None if v is None else
              0.7 + 0.6 * torch.rand(v.shape, generator=gen, device=dev)
              for k, v in params.items()}
    sim = FERSimulator(decoder, AWGNChannel(code, decoding_type=dec, device=dev),
                       batch=B, stop=stop, codewords=words, inner_steps=K, mesh=mesh)
    return sim, params, float(code.snr_sigmas([snr])[0])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("path", GRAPH_PATHS, ids=lambda p: p[0])
def test_graph_replay_equals_eager_steps_on_card(path, K):
    """One replay of the captured K steps counts what K eager steps count
    from the same generator state, leaves the generator where they leave
    it, and counts its launches once per replay (none at the capture): K,
    or one of B2 over the whole read under the early stop."""
    dev = _cuda()
    sim, params, sigma = _graph_sim(dev, path, K)
    kern = sim.decoder.kernel
    gen = torch.Generator(device=dev).manual_seed(5)
    s0 = gen.get_state()
    graphed = [sim._chunk(params, gen, sigma).clone() for _ in range(2)]
    s_graph = gen.get_state()
    launches = dict(kern.launches)
    gen.set_state(s0)
    with torch.no_grad():
        eager = [sim._local_step(params, gen, sigma) for _ in range(2)]
    torch.cuda.synchronize()
    assert [g.tolist() for g in graphed] == [e.tolist() for e in eager]
    assert graphed[0].tolist() != graphed[1].tolist()  # two chunks, two draws
    assert torch.equal(gen.get_state(), s_graph)
    per = 1 if path[0] == "early_stop" else K
    assert sum(launches.values()) == 2 * per and len(launches) == 1
    assert sum(kern.launches.values()) == 4 * per and not kern.captured


@pytest.mark.cuda
def test_k_step_call_does_not_synchronise_on_card():
    """The steps and a replay enqueue work without waiting for the card."""
    dev = _cuda()
    sim, params, sigma = _graph_sim(dev, GRAPH_PATHS[1], 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    sim._chunk(params, gen, sigma)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim._chunk(params, gen, sigma)
        with torch.no_grad():
            sim._local_step(params, gen, sigma)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_changed_sigma_or_params_capture_a_new_graph_on_card():
    dev = _cuda()
    sim, params, sigma = _graph_sim(dev, GRAPH_PATHS[0], 2)
    gen = torch.Generator(device=dev).manual_seed(5)
    sim._chunk(params, gen, sigma)
    first = sim._graphed
    sim._chunk(params, gen, sigma)
    assert sim._graphed is first
    for args in ((params, gen, sigma * 1.25),
                 ({k: None if v is None else v.clone() for k, v in params.items()},
                  gen, sigma),
                 (params, torch.Generator(device=dev).manual_seed(5), sigma)):
        before = sim._graphed
        sim._chunk(*args)
        assert sim._graphed is not before and sim._graphed.fits(
            sim._graphed.key, args[0], args[1])
    # a replay reads the parameters' current values: an in-place change
    # shows without a new capture
    s = gen.get_state()
    a = sim._chunk(params, gen, sigma).clone()
    g = sim._graphed
    for v in params.values():
        if v is not None:
            v.mul_(0.5)
    gen.set_state(s)
    b = sim._chunk(params, gen, sigma).clone()
    with torch.no_grad():
        gen.set_state(s)
        c = sim._local_step(params, gen, sigma)
    assert sim._graphed is g
    assert b.tolist() == c.tolist() and a.tolist() != b.tolist()


# The mesh's host read (`sim/fer.py::_read`) under an NCCL world of one:
# the replay, then one all-reduce of its counters and the checkpoint flag


@pytest.fixture(scope="module")
def nccl_world_of_one():
    import torch.distributed as dist

    from ldpc_error_floor_tpu_torch.parallel import data_mesh
    _cuda()
    made = not dist.is_initialized()
    yield data_mesh(device="cuda")
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_mesh_read_equals_plain_read_on_card(nccl_world_of_one, K):
    """A read's counters summed over a world of one are the replay's, from
    the same generator state, and the flag comes back summed."""
    dev = _cuda()
    mesh = nccl_world_of_one
    reads = []
    for m, due in ((None, False), (mesh, True)):
        sim, params, sigma = _graph_sim(dev, GRAPH_PATHS[1], K, mesh=m)
        gen = torch.Generator(device=dev).manual_seed(5)
        reads.append([sim._read(params, gen, sigma, due).get() for _ in range(2)])
    assert [r[0] for r in reads[0]] == [r[0] for r in reads[1]]
    assert reads[0][0][0] != reads[0][1][0]
    assert [r[1] for r in reads[0]] == [False] * 2
    assert [r[1] for r in reads[1]] == [True] * 2


@pytest.mark.cuda
def test_mesh_read_does_not_synchronise_on_card(nccl_world_of_one):
    """The replay, the all-reduce and the copy to pinned memory are
    enqueued without waiting for the card."""
    dev = _cuda()
    sim, params, sigma = _graph_sim(dev, GRAPH_PATHS[1], 4, mesh=nccl_world_of_one)
    gen = torch.Generator(device=dev).manual_seed(5)
    sim._read(params, gen, sigma, False).get()  # the capture, NCCL's first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [sim._read(params, gen, sigma, False) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(p.get()[0] for p in pending)


@pytest.mark.cuda
def test_mesh_point_recaptures_on_a_new_generator_on_card(nccl_world_of_one):
    """In a world of one a point draws from the caller's generator, so a
    point on another generator captures its own graph."""
    dev = _cuda()
    sim, params, _ = _graph_sim(dev, GRAPH_PATHS[1], 2, mesh=nccl_world_of_one)
    graphs = []
    for seed in (5, 6):
        gen = torch.Generator(device=dev).manual_seed(seed)
        sim.run_point(params, 3.0, gen, max_frames=4000, target_frame_errors=None)
        assert sim._graphed.generator is gen
        graphs.append(sim._graphed)
    assert graphs[0] is not graphs[1]


# The channel sampler's kernel (S1, `csrc/awgn_llr.cu`) against its plain
# version (`AWGNChannel.llr_plain`) on the same noise, bit for bit as int32
# views (signs of zero included): (decoding type, q_bit) for QMS on every
# grid, MS, MS_RAW and SP; wman at the main path's batch and the 5G code
# with punctured and shortened rows at a batch that is not a multiple of 4
SAMPLER_TYPES = [(2, 6), (2, 5), (2, -5), (2, 4), (2, 3), (1, 5), (3, 5), (0, 5)]


def _tie_noise(noise, sig, step):
    """Columns 0 and 1 at sigma 1, their noise landing every LLR on a tie
    of the grid (x / step = k + 1/2); column 1's negative ties round to -0
    under QMS before the punctured rows' blend."""
    R = noise.shape[0]
    k = torch.arange(R, device=noise.device, dtype=torch.float32) % 7 - 3
    noise[:, 0] = 1.0 + step * (k + 0.5) / 2
    noise[:, 1] = 1.0 - step * (k + 0.5) / 2
    sig[:2] = 1.0


def _int_mismatches(a, b):
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("code_name,B", [(WMAN, 65536), (G5, 1001)], ids=["wman", "5g"])
@pytest.mark.parametrize("dec,q_bit", SAMPLER_TYPES, ids=lambda v: str(v))
def test_sampler_matches_plain_bitwise_on_card(code_name, B, dec, q_bit):
    from ldpc_error_floor_tpu_torch.channel import mix_sigma_lanes
    from ldpc_error_floor_tpu_torch.codes import Encoder
    dev = _cuda()
    code = get_code(code_name)
    ch = AWGNChannel(code, decoding_type=dec, q_bit=q_bit, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    bits = Encoder(TannerGraph(code), device=dev).random_codewords(gen, B)
    one = torch.full((B,), float(code.snr_sigmas([3.0])[0]), device=dev)
    mixed = torch.as_tensor(mix_sigma_lanes(code.snr_sigmas([1.0, 3.0, 5.5]), B), device=dev)
    for sig in (one, mixed):
        sig = sig.clone()
        noise = torch.randn((code.n_full, B), generator=gen, device=dev)
        _tie_noise(noise, sig, ch.llr_params.step)
        for b, fold in ((None, False), (bits, False), (bits, True)):
            ch.launches.clear()
            out = ch.llr(noise, sig, b, fold)
            assert ch.launches == {"awgn_llr": 1}
            assert _int_mismatches(out, ch.llr_plain(noise, sig, b, fold)) == 0


@pytest.mark.cuda
def test_sampler_entry_points_one_launch_on_card():
    """`sample` and `sample_codewords` draw `randn` and launch the kernel
    once, with no elementwise PyTorch launch of their own."""
    dev = _cuda()
    code = get_code(G5)
    ch = AWGNChannel(code, decoding_type=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    sig = torch.full((1001,), float(code.snr_sigmas([2.0])[0]), device=dev)
    bits = (torch.rand((code.n_full, 1001), generator=gen, device=dev) < 0.5).float()
    for fold in (None, False, True):
        s0 = gen.get_state()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = (ch.sample(gen, sig) if fold is None
                   else ch.sample_codewords(gen, sig, bits, fold=fold))
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        gen.set_state(s0)
        noise = torch.randn((code.n_full, 1001), generator=gen, device=dev)
        want = ch.llr_plain(noise, sig, None if fold is None else bits, bool(fold))
        assert _int_mismatches(out, want) == 0
        kernels = [n for n in names if "awgn_llr" in n]
        others = [n for n in names if "awgn_llr" not in n and "normal" not in n]
        assert len(kernels) == 1 and not others, names
    assert ch.launches == {"awgn_llr": 3}


@pytest.mark.cuda
def test_sampler_rejects_bad_inputs_on_card():
    dev = _cuda()
    ch = AWGNChannel(get_code(WMAN), device=dev)
    R = ch.code.n_full
    noise = torch.randn((R, 64), device=dev)
    sig = torch.ones(64, device=dev)
    for args in ((noise.double(), sig), (noise, sig[:63]), (noise, sig.double()),
                 (noise.t(), torch.ones(R, device=dev)), (noise, sig, None, True),
                 (noise, sig, torch.zeros((R, 63), device=dev))):
        with pytest.raises(ValueError):
            ch.llr(*args)
    assert not ch.launches


@pytest.mark.cuda
@pytest.mark.parametrize("path", GRAPH_PATHS, ids=lambda p: p[0])
def test_graph_counts_sampler_launches_on_card(path):
    """A replay of K captured steps counts K sampler launches, none at the
    capture."""
    dev = _cuda()
    sim, params, sigma = _graph_sim(dev, path, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    sim._chunk(params, gen, sigma)
    assert sim.channel.launches == {"awgn_llr": 4} and not sim.channel.captured
    sim._chunk(params, gen, sigma)
    assert sim.channel.launches == {"awgn_llr": 8}

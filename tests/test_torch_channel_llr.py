"""The channel sampler's plain version (`AWGNChannel.llr_plain`, the
function the `awgn_llr` kernel is held to) against the JAX package's
channel, bit for bit as int32 views, so that -0 and +0 differ.

Both packages start from the same float32 noise, made with NumPy from a
seed, and go through the sampler's whole expression: ``-1 + noise*sigma``
(or the codeword bits' ``2b - 1 + noise*sigma``), `_llr` and the random
codeword step's fold ``llr * (1 - 2b)``.  The JAX side runs the package's
operations one by one, each an IEEE-rounded operation, as its code states
them: under `jax.jit` XLA's CPU backend contracts ``-1 + noise*sigma`` into
one fused multiply-add, which rounds once where the code rounds twice, so
the jitted CPU step is not the reference for bit-equality (the kernel keeps
the two roundings, `csrc/awgn_llr.cu`).  Columns 0 and 1 of every batch sit
at sigma 1 with noise that lands each LLR on a tie of the QMS grid (x/step
= k + 1/2, rounded half to even), the negative ones rounding to -0 before
the punctured rows' blend turns them into +0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu_torch.channel import AWGNChannel, mix_sigma_lanes
from ldpc_error_floor_tpu_torch.codes import available_codes, get_code
from ldpc_error_floor_tpu_torch.ops import awgn_llr
from ldpc_error_floor_tpu_torch.ops import fused_decoder as fd
from ldpc_error_floor_tpu_torch.ops.ste import qms_grid

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"  # punctured and shortened rows
B = 48
# (decoding type, q_bit): QMS on every grid, MS, MS_RAW, SP
TYPES = [(2, 6), (2, 5), (2, -5), (2, 4), (2, 3), (1, 5), (3, 5), (0, 5)]
PATHS = ["zero", "codewords", "fold"]


def _inputs(code_name, step, seed):
    """float32 noise [N*z, B], mixed sigma lanes [B] with the tie columns,
    codeword-like bits [N*z, B] in {0, 1} (the channel takes any bits)."""
    code = jax_get_code(code_name)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((code.n_full, B)).astype(np.float32)
    sig = mix_sigma_lanes(code.snr_sigmas([1.0, 2.5, 4.0, 5.5]), B).copy()
    k = (np.arange(code.n_full) % 7 - 3).astype(np.float32)
    noise[:, 0] = 1.0 + step * (k + 0.5) / 2  # y = step*(k+1/2)/2: llr/step = k + 1/2
    noise[:, 1] = 1.0 - step * (k + 0.5) / 2
    sig[:2] = 1.0
    bits = (rng.random(noise.shape) < 0.5).astype(np.float32)
    return noise, sig, bits


def _jax_llr(code_name, dec, q_bit, noise, sig, bits, fold):
    """The JAX package's sampler body after the noise (`sample` or
    `sample_codewords`, `_llr`) and the step's fold, operation by operation."""
    ch = JaxChannel(jax_get_code(code_name), decoding_type=dec, q_bit=q_bit)
    noise, sig = jnp.asarray(noise), jnp.asarray(sig)
    if bits is None:
        y = -1.0 + noise * sig[None, :]
    else:
        bits = jnp.asarray(bits)
        y = (2.0 * bits.astype(jnp.float32) - 1.0) + noise * sig[None, :]
    llr = ch._llr(y, sig)
    if fold:
        llr = llr * (1.0 - 2.0 * bits)
    return np.asarray(llr)


def _port_llr(code_name, dec, q_bit, noise, sig, bits, fold, entry="llr"):
    ch = AWGNChannel(get_code(code_name), decoding_type=dec, q_bit=q_bit, device="cpu")
    args = (torch.from_numpy(noise), torch.from_numpy(sig),
            None if bits is None else torch.from_numpy(bits), fold)
    out = getattr(ch, entry)(*args)
    assert out.dtype == torch.float32 and not ch.launches
    return out.numpy()


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dec,q_bit", TYPES, ids=lambda v: str(v))
@pytest.mark.parametrize("code_name", [WMAN, G5], ids=["wman", "5g"])
def test_plain_llr_bitwise_against_jax(code_name, dec, q_bit, path):
    step = qms_grid(q_bit)[0] if dec == 2 else 1.0
    noise, sig, bits = _inputs(code_name, step, seed=3 * TYPES.index((dec, q_bit))
                               + PATHS.index(path))
    b = None if path == "zero" else bits
    ref = _jax_llr(code_name, dec, q_bit, noise, sig, b, path == "fold")
    for entry in ("llr", "llr_plain"):
        ours = _port_llr(code_name, dec, q_bit, noise, sig, b, path == "fold", entry)
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    if code_name == G5 and path != "fold":  # the punctured and shortened rows
        assert (ours[:64].view(np.int32) == np.float32(0.001 if dec == 0 else 0.0)
                .view(np.int32)).all()
        assert (ours[256:320] == -20.0).all()


@pytest.mark.parametrize("q_bit", [6, 5, -5, 4, 3])
def test_grid_ties_and_negative_zero_before_the_blend(q_bit):
    """The tie columns really land on ties, round half to even, and the
    negative ones give -0 before the blend; after it every zero is +0
    (the zero word) and the fold gives -0 back for a bit of 1."""
    step, clip = qms_grid(q_bit)
    noise, sig, bits = _inputs(WMAN, step, seed=7)
    noise[:, 2], sig[2], bits[:, 2] = -1.0, 1.0, 1.0  # a word bit of 1 with y = +0
    n, s = torch.from_numpy(noise[:, :2]), torch.from_numpy(sig[:2])
    pre = 2.0 * (-1.0 + n * s[None, :]) / (s[None, :] ** 2)
    x = pre / step
    assert bool(((x - torch.floor(x)) == 0.5).all())  # every element a tie
    q = torch.clamp(torch.round(x) * step, -clip, clip)
    assert bool(((q == 0) & torch.signbit(q)).any())  # -0 before the blend
    assert bool((torch.round(x) % 2 == 0).all())      # half to even
    ref = _jax_llr(WMAN, 2, q_bit, noise, sig, None, False)
    ours = _port_llr(WMAN, 2, q_bit, noise, sig, None, False)
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    zeros = ours[:, :2] == 0
    assert zeros.any() and not np.signbit(ours[:, :2][zeros]).any()
    folded = _port_llr(WMAN, 2, q_bit, noise, sig, bits, True)
    ref_f = _jax_llr(WMAN, 2, q_bit, noise, sig, bits, True)
    np.testing.assert_array_equal(folded.view(np.int32), ref_f.view(np.int32))
    assert (folded[:, 2].view(np.int32) == np.float32(-0.0).view(np.int32)).all()


@pytest.mark.parametrize("code_name", sorted(available_codes()))
def test_launch_params_rebuild_the_masks(code_name):
    """The kernel's row ranges, punctured value and grid give back the
    channel's `_punct` / `_short` masks and `_llr`'s constants, for every
    bundled code and decoding type."""
    code = get_code(code_name)
    rows = np.arange(code.n_full)
    for dec, q_bit in TYPES:
        ch = AWGNChannel(code, decoding_type=dec, q_bit=q_bit, clip_llr=17.5, device="cpu")
        prm = ch.llr_params
        for (lo, hi), mask in ((prm.punct_rows, ch._punct), (prm.short_rows, ch._short)):
            assert 0 <= lo <= hi <= code.n_full
            rebuilt = ((rows >= lo) & (rows < hi)).astype(np.float32)[:, None]
            np.testing.assert_array_equal(rebuilt, mask.numpy())
        assert prm.punct_val == (0.001 if dec == 0 else 0.0)
        assert prm.quantize == (dec == 2) and prm.clip_llr == 17.5
        if dec == 2:
            assert (prm.step, prm.clip) == qms_grid(q_bit)


def test_cpu_never_builds_or_loads_the_library(monkeypatch):
    """`device='cpu'` runs the plain version: the sampler, the simulator's
    random-codeword step and a harvester batch never build or load a
    kernel library."""
    from ldpc_error_floor_tpu_torch.codes import TannerGraph
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder, WeightSpec,
                                                   init_weights)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator, UncorHarvester

    def refuse(*_a, **_k):
        raise AssertionError("a kernel library was built or loaded on the CPU")

    for mod, name in ((awgn_llr, "load_library"), (awgn_llr, "launch"),
                      (fd, "build_library"), (fd, "load_library"), (fd, "_find_nvcc")):
        monkeypatch.setattr(mod, name, refuse)
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 3, 3), n_iters=2)
    dec = NMSDecoder(code, DecoderConfig(), spec, graph=graph, device="cpu")
    ch = AWGNChannel(code, device="cpu")
    sig = torch.full((8,), float(code.snr_sigmas([2.0])[0]))
    gen = torch.Generator().manual_seed(0)
    assert ch.sample(gen, sig).shape == (code.n_full, 8)
    bits = (torch.rand((code.n_full, 8), generator=gen) < 0.5).float()
    assert ch.sample_codewords(gen, sig, bits, fold=True).shape == (code.n_full, 8)
    params = init_weights(spec, graph, device="cpu")
    sim = FERSimulator(dec, ch, batch=8, codewords="random")
    assert sim._chunk(params, gen, float(sig[0])).shape == (3,)
    UncorHarvester(dec, ch, batch=8)._step(params, gen, float(sig[0]))
    assert not ch.launches and not ch.captured and not dec.kernel.launches


def test_simulator_fold_is_the_plain_fold():
    """The random-codeword step's LLRs are the channel's folded LLRs, the
    JAX step's ``llr * (1 - 2*bits)``, on the same generator draws."""
    from ldpc_error_floor_tpu_torch.codes import Encoder, TannerGraph
    from ldpc_error_floor_tpu_torch.models import DecoderConfig, NMSDecoder, WeightSpec
    from ldpc_error_floor_tpu_torch.sim import FERSimulator
    code = get_code(G5)
    graph = TannerGraph(code)
    dec = NMSDecoder(code, DecoderConfig(), WeightSpec(sharing=(3, 3, 3), n_iters=2),
                     graph=graph, device="cpu")
    ch = AWGNChannel(code, device="cpu")
    sim = FERSimulator(dec, ch, batch=16, codewords="random")
    sigma = float(np.float32(code.snr_sigmas([2.0])[0]))
    got = sim._sample(torch.Generator().manual_seed(3), sigma)
    gen = torch.Generator().manual_seed(3)
    bits = Encoder(graph, device="cpu").random_codewords(gen, 16)
    llr = ch.sample_codewords(gen, torch.full((16,), sigma), bits)
    want = llr * (1.0 - 2.0 * bits)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))

"""The port's AWGN channel: LLR formation bit-identical to the JAX package's
on the same noise, and the sampler statistically right."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
from ldpc_error_floor_tpu.channel import mix_sigma_lanes as jax_mix_sigma_lanes
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu_torch.channel import AWGNChannel, mix_sigma_lanes
from ldpc_error_floor_tpu_torch.codes import get_code

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"
G5 = "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320"


@pytest.mark.parametrize("code_name,dec", [(WMAN, 2), (G5, 2), (G5, 0), (WMAN, 1)],
                         ids=["wman_qms", "5g_qms", "5g_sp", "wman_ms"])
def test_llr_bit_identical_to_jax(code_name, dec):
    rng = np.random.default_rng(3)
    jcode = jax_get_code(code_name)
    B = 48
    sig = mix_sigma_lanes(jcode.snr_sigmas([1.0, 2.5, 4.0]), B)
    np.testing.assert_array_equal(sig, jax_mix_sigma_lanes(jcode.snr_sigmas([1.0, 2.5, 4.0]), B))
    y = (-1.0 + rng.standard_normal((jcode.n_full, B)) * sig).astype(np.float32)
    ref = np.asarray(JaxChannel(jcode, decoding_type=dec, q_bit=5)._llr(
        jnp.asarray(y), jnp.asarray(sig)))
    ours = AWGNChannel(get_code(code_name), decoding_type=dec, q_bit=5,
                       device="cpu")._llr(torch.from_numpy(y), torch.from_numpy(sig))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
    if code_name == G5:  # punctured and shortened ranges are set
        assert bool((ours[:64] == (0.001 if dec == 0 else 0.0)).all())
        assert bool((ours[256:320] == -20.0).all())


def test_sampler_statistics():
    code = get_code(WMAN)
    ch = AWGNChannel(code, decoding_type=1, device="cpu")  # unquantized LLRs
    sigma = float(code.snr_sigmas([2.0])[0])
    sig = torch.full((512,), sigma)
    llr = ch.sample(torch.Generator().manual_seed(0), sig)
    assert llr.shape == (code.n_full, 512)
    n = llr.numel()
    # LLR = 2y/sigma^2 with y ~ N(-1, sigma^2): mean -2/sigma^2, std 2/sigma
    mean, std = -2.0 / sigma ** 2, 2.0 / sigma
    assert abs(llr.mean().item() - mean) < 5 * std / np.sqrt(n)
    assert abs(llr.std().item() / std - 1.0) < 5 * np.sqrt(0.5 / n)
    again = ch.sample(torch.Generator().manual_seed(0), sig)
    other = ch.sample(torch.Generator().manual_seed(1), sig)
    assert torch.equal(llr, again) and not torch.equal(llr, other)

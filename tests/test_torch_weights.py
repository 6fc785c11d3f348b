"""The port's weight files and parameter handling against the JAX package's."""

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu.io.weight_files import (
    available_weight_sets as jax_available_weight_sets,
    write_weight_file as jax_write_weight_file)
from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
from ldpc_error_floor_tpu.models import load_params as jax_load_params
from ldpc_error_floor_tpu.models import stack_weights as jax_stack_weights
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io import (available_weight_sets,
                                           read_weight_file, read_weight_json,
                                           write_weight_file)
from ldpc_error_floor_tpu_torch.models import (WeightSpec, init_weights,
                                               load_params, params_from_numpy,
                                               stack_weights)

torch.set_num_threads(1)

WMAN = "wman_N0576_R34_z24"


def _code_of(weight_set):
    return next(c for c in ("wman_N0576_R34_z24", "802_11n_N648_R56_z27",
                            "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320",
                            "5G_LDPC_R0.33_n_dec896_n768_k256_z32_s257_320",
                            "5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640",
                            "5G_LDPC_R0.73_n_dec480_n352_k256_z32_s257_320")
                if weight_set.startswith(c))


def _np(params):
    return {k: None if v is None else np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("name", jax_available_weight_sets())
def test_bundled_weight_set_loads_equal(name):
    assert available_weight_sets() == jax_available_weight_sets()
    sharing, blocks = read_weight_json(name)
    T = len(next(v for v in blocks.values() if v is not None))
    code_name = _code_of(name)
    spec = WeightSpec(sharing=tuple(sharing), n_iters=T)
    jspec = JaxSpec(sharing=tuple(sharing), n_iters=T)
    ours = load_params(spec, TannerGraph(get_code(code_name)), name, device="cpu")
    ref = jax_load_params(jspec, JaxGraph(jax_get_code(code_name)), name)
    for k in ("cn", "ucn", "vn"):
        if ref[k] is None:
            assert ours[k] is None
        else:
            assert ours[k].dtype == torch.float32
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("sharing", [(3, 3, 3), (1, 1, 0), (2, 2, 2), (4, 4, 5)])
def test_stack_weights_equal(sharing):
    rng = np.random.default_rng(5)
    fixed = 2 if any(s in (4, 5) for s in sharing) else 0
    spec = WeightSpec(sharing=sharing, n_iters=6, fixed_iter=fixed)
    jspec = JaxSpec(sharing=sharing, n_iters=6, fixed_iter=fixed)
    jgraph = JaxGraph(jax_get_code(WMAN))
    params = {k: None if jspec.dim(k, jgraph) == 0 else
              rng.uniform(0.5, 1.5, (jspec.n_rows(k), jspec.dim(k, jgraph)))
              .astype(np.float32) for k in ("cn", "ucn", "vn")}
    ours = stack_weights(spec, params_from_numpy(params, device="cpu"))
    ref = jax_stack_weights(jspec, params)
    for k in ("cn", "ucn", "vn"):
        if ref[k] is None:
            assert ours[k] is None
        else:
            assert ours[k].shape == (6, jspec.dim(k, jgraph))
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_stack_weights_copies_the_row_index_once():
    """The row index reaches the device once per (spec, kind, device): a copy
    from the host on every call would make each training step wait for the
    card.  A spec built from a JSON list equals and hashes as one built
    from a tuple."""
    from ldpc_error_floor_tpu_torch.models.weights import _iter_rows
    spec = WeightSpec(sharing=[4, 4, 5], n_iters=6, fixed_iter=2)
    same = WeightSpec(sharing=(4, 4, 5), n_iters=6, fixed_iter=2)
    assert spec == same and hash(spec) == hash(same)
    params = init_weights(spec, TannerGraph(get_code(WMAN)), device="cpu")
    first = stack_weights(spec, params)
    rows = _iter_rows(spec, "cn", torch.device("cpu"))
    second = stack_weights(spec, params)
    assert _iter_rows(same, "cn", torch.device("cpu")) is rows
    assert rows.tolist() == spec.iter_to_row("cn").tolist()
    for k in ("cn", "ucn", "vn"):
        assert torch.equal(first[k], second[k])


def test_params_from_numpy_round_trip():
    rng = np.random.default_rng(1)
    params = {"cn": rng.standard_normal((4, 6)).astype(np.float32),
              "ucn": None, "vn": rng.standard_normal((4, 1))}
    ours = params_from_numpy(params, device="cpu")
    assert ours["ucn"] is None and ours["vn"].dtype == torch.float32
    back = _np(ours)
    np.testing.assert_array_equal(back["cn"], params["cn"])
    np.testing.assert_array_equal(back["vn"], params["vn"].astype(np.float32))
    params["cn"][0, 0] = 99.0  # the port holds its own copy
    assert ours["cn"][0, 0] != 99.0


def test_init_weights_constant_and_random():
    graph = TannerGraph(get_code(WMAN))
    spec = WeightSpec(sharing=(2, 2, 2), n_iters=5)
    ones = init_weights(spec, graph, device="cpu")
    assert ones["cn"].shape == (5, 6) and ones["vn"].shape == (5, 24)
    assert bool((ones["ucn"] == 1.0).all())
    gen = torch.Generator().manual_seed(0)
    rnd = init_weights(spec, graph, init_cn=-1, init_vn=-1, generator=gen,
                       device="cpu")
    for k in ("cn", "ucn", "vn"):
        assert bool(((rnd[k] >= 0.8) & (rnd[k] <= 1.2)).all())
    with pytest.raises(ValueError, match="Generator"):
        init_weights(spec, graph, init_cn=-1, device="cpu")


def test_text_weight_file_round_trip_matches_jax(tmp_path):
    sharing, blocks = read_weight_json(f"{WMAN}_base20")
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    write_weight_file(str(ours), sharing, blocks)
    jax_write_weight_file(str(ref), sharing, blocks)
    assert ours.read_bytes() == ref.read_bytes()
    sharing2, blocks2 = read_weight_file(str(ours))
    assert tuple(sharing2) == tuple(sharing)
    for k in ("cn", "ucn", "vn"):
        np.testing.assert_array_equal(np.stack(blocks2[k]), np.stack(blocks[k]))

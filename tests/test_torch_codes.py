"""The port's codes and Tanner graphs against the JAX package's, the bundled
data copies, and the port's independence from JAX."""

import ast
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
from ldpc_error_floor_tpu.codes import available_codes as jax_available_codes
from ldpc_error_floor_tpu.codes import get_code as jax_get_code
from ldpc_error_floor_tpu_torch.codes import TannerGraph, available_codes, get_code

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ldpc_error_floor_tpu_torch"

GRAPH_TABLES = ("edge_cn", "edge_vn", "edge_shift", "cn_order_of_edge",
                "edge_of_cn_order", "vn_slots", "cn_slots", "cn_in_idx",
                "vn_in_idx", "cn_vn_idx", "cn_slot_edge_idx", "H")


def test_code_registry_matches():
    assert available_codes() == jax_available_codes()
    assert len(available_codes()) == 10


@pytest.mark.parametrize("name", jax_available_codes())
def test_tanner_graph_tables_match(name):
    code, jcode = get_code(name), jax_get_code(name)
    np.testing.assert_array_equal(code.proto, jcode.proto)
    for attr in ("M", "N", "z", "punct", "short", "n", "k", "rate",
                 "n_edges"):
        assert getattr(code, attr) == getattr(jcode, attr), attr
    np.testing.assert_array_equal(code.snr_sigmas([1.0, 4.0]),
                                  jcode.snr_sigmas([1.0, 4.0]))
    g, jg = TannerGraph(code), JaxGraph(jcode)
    assert (g.E, g.Dv, g.Dc) == (jg.E, jg.Dv, jg.Dc)
    for attr in GRAPH_TABLES:
        a, b = getattr(g, attr), getattr(jg, attr)
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)


@pytest.mark.parametrize("kind", ["codes", "weights"])
def test_data_copies_are_byte_identical(kind):
    src = REPO / "ldpc_error_floor_tpu" / "data" / kind
    dst = PORT / "data" / kind
    names = sorted(os.listdir(src))
    assert names == sorted(os.listdir(dst)) and len(names) == 10
    match, mismatch, errors = filecmp.cmpfiles(src, dst, names, shallow=False)
    assert match == names, (mismatch, errors)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every port module in a fresh interpreter (this pytest process
    already holds JAX) and check what came along."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'jaxlib' or m == 'ldpc_error_floor_tpu'"
            " or m.startswith('ldpc_error_floor_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ldpc_error_floor_tpu"), \
                f"{path.relative_to(REPO)} imports {name}"

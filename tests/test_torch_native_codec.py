"""The port's native Uncor codec against its NumPy reference: the same
bytes written, the same values parsed, ragged rows rejected, and the
reference format's semantics (3 metadata columns, negated storage,
'%.1f').  The port's counterpart of `tests/test_native_codec.py`; it
imports nothing of JAX."""

import numpy as np
import pytest

from ldpc_error_floor_tpu_torch import native
from ldpc_error_floor_tpu_torch.io.uncor_files import (append_uncor_file,
                                                       append_uncor_file_plain,
                                                       read_uncor_file,
                                                       read_uncor_file_plain)


def _rand_llrs(rows, cols, seed=0):
    rng = np.random.default_rng(seed)
    # one-decimal values (the on-disk precision), negatives, zeros and -0.0
    x = np.round(rng.normal(0.0, 4.0, (rows, cols)) * 10) / 10
    x[0, :3] = [0.0, -0.0, 7.25]  # a value off the 0.5 grid takes printf's path
    return x.astype(np.float32)


def test_write_matches_numpy_bytes(tmp_path):
    llrs = _rand_llrs(50, 96)
    f_nat, f_np = str(tmp_path / "nat.txt"), str(tmp_path / "np.txt")
    for _ in range(2):  # append mode
        append_uncor_file(f_nat, llrs)
        append_uncor_file_plain(f_np, llrs)
    assert open(f_nat, "rb").read() == open(f_np, "rb").read()


def test_parse_matches_numpy(tmp_path):
    llrs = _rand_llrs(40, 64, seed=3)
    path = str(tmp_path / "u.txt")
    append_uncor_file_plain(path, llrs)
    append_uncor_file_plain(path, llrs * 0.5)
    got = read_uncor_file(path)
    ref = read_uncor_file_plain(path)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (80, 64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))
    np.testing.assert_array_equal(read_uncor_file(path, max_rows=7), ref[:7])


def test_roundtrip_and_max_rows(tmp_path):
    llrs = _rand_llrs(20, 48, seed=7)
    path = str(tmp_path / "u.txt")
    append_uncor_file(path, llrs)
    np.testing.assert_allclose(read_uncor_file(path), llrs, atol=0.05)
    with pytest.raises(ValueError, match="need 21"):
        read_uncor_file(path, max_rows=21)


def test_parse_rejects_ragged(tmp_path):
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("0.0\t0.0\t0.0\t1.0\t2.0\n")
        f.write("0.0\t0.0\t0.0\t1.0\n")  # short row
    with pytest.raises(ValueError, match="malformed"):
        read_uncor_file(path)
    with open(path, "w") as f:
        f.write("0.0\t0.0\t0.0\t1.0\tx\n")  # not a number
    with pytest.raises(ValueError, match="malformed"):
        read_uncor_file(path)


def test_library_built_once_into_the_build_directory():
    lib = native.load_library()
    assert native.load_library() is lib
    built = list(native._BUILD_DIR.glob("uncor_codec_*.so"))
    assert built and not list(native._BUILD_DIR.glob("uncor_codec_*.tmp"))

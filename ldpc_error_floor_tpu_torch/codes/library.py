"""Bundled code library.

Mirrors the reference's `BaseGraph/` directory (see SURVEY.md section 2.1 for
the per-file parameters).  Proto matrices are stored in this framework's
compact JSON form under `ldpc_error_floor_tpu_torch/data/codes/`; they are
standards-defined base graphs (IEEE 802.16e WiMAX, IEEE 802.11n WiFi, 3GPP
5G NR) plus classic MacKay/BCH/Polar parity-check matrices.

Default puncture/shorten ranges for the 5G codes are derived from their
filenames (n_dec = N*z stored bits, n = transmitted bits, s<a>_<b> =
shortened range): the difference n_dec - n - short_num is always the
standard 2*z leading punctured systematic bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ldpc_error_floor_tpu_torch.codes.protograph import Code

# name -> (z, punct(1-indexed incl, 0=off), short)
_REGISTRY: Dict[str, Tuple[int, Tuple[int, int], Tuple[int, int]]] = {
    "wman_N0576_R34_z24": (24, (0, 0), (0, 0)),
    "802_11n_N648_R56_z27": (27, (0, 0), (0, 0)),
    "5G_LDPC_R0.50_n_dec640_n512_k256_z32_s257_320": (32, (1, 64), (257, 320)),
    "5G_LDPC_R0.33_n_dec896_n768_k256_z32_s257_320": (32, (1, 64), (257, 320)),
    "5G_LDPC_R0.50_n_dec1280_n1024_k512_z64_s513_640": (64, (1, 128), (513, 640)),
    "5G_LDPC_R0.73_n_dec480_n352_k256_z32_s257_320": (32, (1, 64), (257, 320)),
    "5G_LDPC_R0.73_n_dec2304_n2112_k1536_z72_s1537_1584": (72, (1, 144), (1537, 1584)),
    "MACKAY_N96_K48": (1, (0, 0), (0, 0)),
    "BCH_63_51": (1, (0, 0), (0, 0)),
    "Polar_64_48": (1, (0, 0), (0, 0)),
}


def available_codes():
    return sorted(_REGISTRY)


def get_code(name: str,
             z: Optional[int] = None,
             punct: Optional[Tuple[int, int]] = None,
             short: Optional[Tuple[int, int]] = None) -> Code:
    """Load a bundled code by name, optionally overriding z/puncture/shorten."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown code {name!r}; available: {available_codes()}")
    z0, punct0, short0 = _REGISTRY[name]
    return Code.load(
        name, z=z if z is not None else z0,
        punct=punct if punct is not None else punct0,
        short=short if short is not None else short0,
        name=name,
    )

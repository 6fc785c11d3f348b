"""Weight-file I/O.

Two formats are supported:

1. The reference's plain-text format (`Print_Functions.py:74-96` writer,
   `Main_Functions.py:418-426` reader) for interop with shipped artifacts:

   * line 1: ``"s0 s1 s2"`` — the sharing triple (CN, UCN, VN), then a blank
     line;
   * for each kind with sharing > 0 (in CN, UCN, VN order):
     ``n_iters`` tab-separated rows (1 value for per-iteration-scalar sharing,
     M or N values for per-proto-node, E values for per-edge; temporal-sharing
     modes re-print the shared row for every iteration past the pivot),
     followed by a blank line.

2. This framework's JSON format (sharing triple + per-kind row lists), used
   for the bundled published weight sets under
   `ldpc_error_floor_tpu_torch/data/weights/`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("cn", "ucn", "vn")

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "weights")

Blocks = Dict[str, Optional[List[np.ndarray]]]


def read_weight_file(path: str) -> Tuple[Tuple[int, int, int], Blocks]:
    """Parse a reference-format weight text file.

    Returns the sharing triple and a dict kind -> list of per-iteration rows
    (float32 arrays), with None for kinds whose sharing is 0.
    """
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    # first non-empty line is the sharing triple
    it = iter(range(len(lines)))
    hdr = None
    for li in it:
        if lines[li].strip():
            hdr = lines[li]
            start = li + 1
            break
    if hdr is None:
        raise ValueError(f"empty weight file: {path}")
    sharing = tuple(int(tok) for tok in hdr.split())
    if len(sharing) != 3:
        raise ValueError(f"bad sharing header {hdr!r} in {path}")

    # group remaining non-empty lines into blank-line-separated blocks
    groups: List[List[np.ndarray]] = []
    cur: List[np.ndarray] = []
    for ln in lines[start:]:
        if ln.strip():
            cur.append(np.asarray([float(tok) for tok in ln.replace("\t", " ").split()],
                                  dtype=np.float32))
        elif cur:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)

    active = [k for k, s in zip(KINDS, sharing) if s > 0]
    if len(groups) != len(active):
        raise ValueError(
            f"{path}: expected {len(active)} weight blocks for sharing {sharing}, "
            f"found {len(groups)}")
    blocks: Blocks = {k: None for k in KINDS}
    for k, g in zip(active, groups):
        blocks[k] = g
    return sharing, blocks  # type: ignore[return-value]


def _fmt_row(row: np.ndarray) -> str:
    # np.savetxt(fmt='%s') on float32 prints the shortest repr; match that.
    return "\t".join(str(np.float32(v)) for v in np.asarray(row).ravel())


def write_weight_file(path: str, sharing: Sequence[int], blocks: Blocks) -> None:
    """Write the reference-format weight text file (byte-compatible layout)."""
    active = [(k, s) for k, s in zip(KINDS, sharing) if s > 0]
    with open(path, "w") as f:
        f.write("{0} {1} {2}\n\n".format(*sharing))
        for bi, (k, s) in enumerate(active):
            rows = blocks[k]
            assert rows is not None, f"sharing[{k}]={s} but no rows given"
            for row in rows:
                f.write(_fmt_row(row) + "\n")
            if bi + 1 < len(active):  # blank separator between kinds; the
                f.write("\n")         # shipped artifacts have no trailing blank


def read_weight_json(path_or_name: str) -> Tuple[Tuple[int, int, int], Blocks]:
    """Read this framework's JSON weight format (or a bundled set by name)."""
    path = bundled_weight_path(path_or_name)
    with open(path) as f:
        obj = json.load(f)
    sharing = tuple(obj["sharing"])
    blocks: Blocks = {}
    for k in KINDS:
        v = obj["blocks"].get(k)
        blocks[k] = None if v is None else [np.asarray(r, np.float32) for r in v]
    return sharing, blocks  # type: ignore[return-value]


def write_weight_json(path: str, sharing: Sequence[int], blocks: Blocks,
                      meta: Optional[dict] = None) -> None:
    obj = {
        "sharing": list(sharing),
        "blocks": {k: (None if blocks.get(k) is None
                       else [list(map(float, r)) for r in blocks[k]])  # type: ignore
                   for k in KINDS},
    }
    if meta:
        obj.update(meta)
    with open(path, "w") as f:
        json.dump(obj, f)


def bundled_weight_path(name: str) -> str:
    if os.path.exists(name):
        return name
    for cand in (os.path.join(_DATA_DIR, name),
                 os.path.join(_DATA_DIR, name + ".json")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"weight set not found: {name!r}")


def available_weight_sets() -> List[str]:
    if not os.path.isdir(_DATA_DIR):
        return []
    return sorted(fn[:-5] for fn in os.listdir(_DATA_DIR) if fn.endswith(".json"))

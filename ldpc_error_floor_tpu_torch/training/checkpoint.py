"""Full training-state checkpoint and resume for the port's own runs.

One file per training block, ``{out_dir}/ckpt/{prefix}_block{start}_{end}/
state.pt``, replaced atomically after each snapshot (written to a temporary
file, then renamed, as `sim/fer.py` writes its JSON checkpoints): the
parameters, the Adam state, the sampling generator's state, the epoch, and
eta / learning rate / best valid metric.  The JAX package's Orbax
directories are not read; the format the two packages share is the weight
text files.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ldpc_error_floor_tpu_torch.models.weights import Params
from ldpc_error_floor_tpu_torch.sim.fer import generator_state, set_generator_state

_FILE = "state.pt"


def block_ckpt_dir(out_dir: str, prefix: str, start: int, end: int) -> str:
    return os.path.join(out_dir, "ckpt", f"{prefix}_block{start}_{end}")


def save_train_state(ckpt_dir: str, epoch: int, params: Params,
                     optimizer: torch.optim.Optimizer,
                     generator: torch.Generator,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot the full training state after `epoch`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {"epoch": int(epoch),
             "params": {k: None if v is None else v.detach().cpu()
                        for k, v in params.items()},
             "optimizer": optimizer.state_dict(),
             "generator": generator_state(generator),
             "extra": {k: float(v) for k, v in (extra or {}).items()}}
    path = os.path.join(ckpt_dir, _FILE)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_train_state(ckpt_dir: str, params: Params,
                        optimizer: torch.optim.Optimizer,
                        generator: torch.Generator
                        ) -> Optional[Dict[str, Any]]:
    """Restore the snapshot into `params` (in place), `optimizer` and
    `generator`; returns ``{"epoch": ..., "extra": {...}}``, or None when the
    directory holds none.  Build `params` and `optimizer` as a fresh run
    would."""
    path = os.path.join(ckpt_dir, _FILE)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k, v in params.items():
            saved = state["params"].get(k)
            if (v is None) != (saved is None):
                raise ValueError(f"{path}: weight kind {k!r} does not match")
            if v is not None:
                v.copy_(saved)
    optimizer.load_state_dict(state["optimizer"])
    set_generator_state(generator, state["generator"])
    return {"epoch": state["epoch"], "extra": state["extra"]}

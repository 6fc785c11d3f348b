"""One command over every card of the host: the launcher of `--mesh`.

JAX's `data_mesh()` takes every device of the process, so one `simulate
--mesh` spreads over the whole host.  The port runs one process per device
(`parallel/mesh.py`), so the same command line starts one rank per card
here and waits for them.  Each rank is the CLI itself, given the
coordinator flags and the same subcommand:

    python -m ldpc_error_floor_tpu_torch.cli --coordinator 127.0.0.1:<port> \
        --num-processes W --process-id r <subcommand and flags>

Rank 0's standard output is the command's (one JSON line per SNR, as
printed); every rank's standard error, and any standard output of the other
ranks, goes to the command's standard error.  The first rank to fail ends
the others at once, so no collective waits out its timeout, and no rank
outlives the command.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence

import torch

_ROOT = str(Path(__file__).resolve().parents[2])  # holds the package
_POLL_S = 0.05


def mesh_world(n_devices: Optional[int] = None, device="cuda") -> int:
    """The ranks of one `--mesh` command: the first `n_devices` devices of
    the host, or all of them (every card for a card; the CPU counts one
    device, as JAX counts a CPU host); more than the host has raises, with
    the message of JAX's `data_mesh`."""
    have = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    need = max(have, 1) if n_devices is None else n_devices
    if not 1 <= need <= have:
        raise ValueError(f"need {need} devices, have {have}")
    return need


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _forward(stream, out) -> None:
    for line in stream:
        out.write(line)
        out.flush()


def _worst(codes: Iterable[int]) -> int:
    """The worst of the ranks' exit codes, a signal's as a shell gives it."""
    return max((128 - c if c < 0 else c for c in codes), default=0)


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def spawn_ranks(argv: Sequence[str], world: int, device="cuda") -> int:
    """Run the CLI command `argv` (a subcommand and its flags) as a world of
    `world` ranks on this host and wait for them; returns the worst exit
    code of the ranks that ended on their own.

    On a card rank r runs on ``cuda:r`` over NCCL, and more ranks than
    cards raise before anything starts.  On the CPU the ranks are gloo
    processes, any number of them.  When a rank exits non-zero, the
    launcher kills the others; so it does when it is interrupted or
    terminated itself."""
    if torch.device(device).type == "cuda":
        mesh_world(world, device)
    port = _free_port()
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=_ROOT if not path else _ROOT + os.pathsep + path)
    out = sys.stdout
    procs, codes, forward = [], {}, None
    # a terminated launcher ends its ranks too (interrupts raise already)
    old = (signal.signal(signal.SIGTERM, _terminated)
           if threading.current_thread() is threading.main_thread() else None)
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ldpc_error_floor_tpu_torch.cli",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 str(world), "--process-id", str(r), *argv],
                env=env, stdout=subprocess.PIPE if r == 0 else 2,
                text=True))
            if r == 0:
                forward = threading.Thread(target=_forward,
                                           args=(procs[0].stdout, out), daemon=True)
                forward.start()
        while len(codes) < world and not any(codes.values()):
            time.sleep(_POLL_S)
            for r, p in enumerate(procs):
                if r not in codes and p.poll() is not None:
                    codes[r] = p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if forward is not None:
            forward.join()
        if old is not None:
            signal.signal(signal.SIGTERM, old)
    return _worst(codes.values())

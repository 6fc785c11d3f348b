"""A cell of several chips: one rank per card, as the port's `--mesh`
launcher (`parallel/launch.py`) starts them.

Rank 0 is the process the benchmark was started as.  It picks a free port
on 127.0.0.1, starts ranks 1..W-1 as copies of its own command with
`--rank r --port p`, and every rank joins the world through the port's
`initialize_distributed` and `data_mesh`.  The ranks agree on when the
window ends (`World.all_done`) and pool their peak memory and card time
(`World.pool`); each rank's reference decodes its own rank's share of
the checked point, rank 0 compares the sums and prints.  Rank 0 waits for every rank it
started and ends any that is still running when it leaves.
"""

from __future__ import annotations

import contextlib
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import torch

JOIN_TIMEOUT_S = 120.0  # a rank that has not ended this long after rank 0 is killed


@dataclass
class World:
    mesh: object
    device: torch.device

    def all_done(self, done: bool) -> bool:
        """Whether any rank's window is over: every rank stops on the same
        point."""
        import torch.distributed as dist
        t = torch.tensor([int(done)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def sum(self, values: List[int]) -> List[int]:
        """Each value summed over the ranks."""
        import torch.distributed as dist
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t.tolist()

    def pool(self, result: dict, peak: int, summary: Optional[dict]) -> dict:
        """Rank 0's result with the largest peak memory of any rank and the
        card busy seconds averaged over the ranks."""
        import torch.distributed as dist
        busy = 0.0 if summary is None else summary["device_busy_ms"] / 1e3
        t = torch.tensor([float(peak), busy], dtype=torch.float64, device=self.device)
        mx = t.clone()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        out = dict(result, memory_peak_bytes=int(mx[0].item()))
        if summary is not None:
            out["busy_s"] = t[1].item() / self.mesh.world
        return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_of(chips: int, rank: int, port: int, argv: List[str],
             script: Optional[str] = None) -> Iterator[Optional[World]]:
    """None for a cell of one chip; else this rank's `World`, rank 0
    starting the others first, each as `script` (`run.py`) with `argv`."""
    if chips == 1:
        yield None
        return
    from ldpc_error_floor_tpu_torch.parallel import data_mesh, initialize_distributed
    procs = []
    if rank == 0:
        port = _free_port()
        script = script or str(Path(__file__).resolve().parent / "run.py")
        for r in range(1, chips):
            procs.append(subprocess.Popen([sys.executable, script, *argv, "--rank", str(r),
                                           "--port", str(port)],
                                          stdout=subprocess.DEVNULL))
    try:
        initialize_distributed(f"127.0.0.1:{port}", chips, rank, device="cuda")
        m = data_mesh(chips)
        yield World(m, m.device)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    finally:
        for p in procs:
            try:
                p.wait(timeout=JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError(f"a rank failed: exit codes {[p.returncode for p in procs]}")

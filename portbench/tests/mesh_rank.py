"""One gloo rank of a small mesh cell on the CPU (`test_mesh.py` starts
four): python mesh_rank.py RANK PORT CELL FAULT."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import harness, mesh, run  # noqa: E402


def main(rank: int, port: int, cell_name: str, fault: str) -> None:
    from ldpc_error_floor_tpu_torch.parallel import data_mesh, initialize_distributed
    torch.set_num_threads(1)
    if fault == "no_exchange":   # the exchange between chips left out
        import ldpc_error_floor_tpu_torch.sim.fer as fer
        fer.all_sum = lambda m, t: t
    bench = harness.load_bench()
    cell = harness.cell(bench, cell_name)
    traffic = harness.traffic(cell["traffic"])
    traffic.update(batch_per_rank=64, inner_steps=2, frames_per_point=1024, snr_db=3.0)
    initialize_distributed(f"127.0.0.1:{port}", cell["chips"], rank, device="cpu")
    m = data_mesh(cell["chips"], device="cpu")
    line = run.run_cell(bench, cell, 9, 0.1, False, device="cpu", rank=rank,
                        world=mesh.World(m, m.device), traffic=traffic)
    if rank == 0:
        print(json.dumps(line))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

"""The control of a cell of several cards: every rank runs the program on
its 4-bit path, rank 0 prints the compared numbers as one JSON line.

    python3 portbench/tests/mesh_control.py --workload <cell> --seed <n> --seconds <s>
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, mesh, run  # noqa: E402
from portbench.tests.test_control import lower_precision  # noqa: E402


def main(argv) -> int:
    args = run.parse(argv)
    bench = harness.load_bench()
    cell = harness.cell(bench, args.workload)
    ctl = lower_precision(harness.config(bench, cell["config"]))
    with mesh.world_of(cell["chips"], args.rank, args.port, argv,
                       script=str(Path(__file__).resolve())) as world:
        line = run.run_cell(bench, cell, args.seed, args.seconds, False, rank=args.rank,
                            world=world, program_cfg=ctl)
    if args.rank == 0:
        print(json.dumps({"correct": line["correct"], "checks": line["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

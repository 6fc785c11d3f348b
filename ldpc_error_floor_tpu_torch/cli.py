"""Command-line interface of the PyTorch port (a subset of
`ldpc_error_floor_tpu/cli.py`):

    python -m ldpc_error_floor_tpu_torch.cli codes
    python -m ldpc_error_floor_tpu_torch.cli simulate --code wman_N0576_R34_z24 \
        --weights wman_N0576_R34_z24_base20 --sharing 3 3 3 --iters 20 \
        --snrs 3.0 3.5 4.0 --target-errors 100

`simulate` runs QMS (q_bit 5) with the genie stop on the all-zero codeword
and prints one JSON line per SNR.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_codes(args) -> int:
    from ldpc_error_floor_tpu_torch.codes import available_codes, get_code
    for name in available_codes():
        c = get_code(name)
        print(f"{name}: M={c.M} N={c.N} z={c.z} E={c.n_edges} "
              f"n={c.n} k={c.k} R={c.rate:.3f}")
    return 0


def _cmd_simulate(args) -> int:
    import torch

    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec, init_weights,
                                                   load_params)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator

    code = get_code(args.code)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=tuple(args.sharing), n_iters=args.iters)
    dec = NMSDecoder(code, DecoderConfig(), spec, graph=graph,
                     device=args.device)
    if args.weights:
        params = load_params(spec, graph, args.weights, device=args.device)
    else:
        params = init_weights(spec, graph, device=args.device)
    ch = AWGNChannel(code, device=args.device)
    sim = FERSimulator(dec, ch, batch=args.batch)
    gen = torch.Generator(device=dec.device).manual_seed(args.seed)
    points = sim.run_curve(params, args.snrs, gen,
                           max_frames=args.max_frames,
                           target_frame_errors=args.target_errors)
    for pt in points:
        print(json.dumps(vars(pt)))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ldpc_error_floor_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("codes", help="list bundled codes")

    pm = sub.add_parser("simulate", help="Monte-Carlo FER curve (genie stop)")
    pm.add_argument("--code", required=True)
    pm.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch version)")
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("--weights", default=None,
                    help="weight file / bundled set (default: all-ones)")
    pm.add_argument("--sharing", type=int, nargs=3, default=[3, 3, 3])
    pm.add_argument("--iters", type=int, default=20)
    pm.add_argument("--snrs", type=float, nargs="+", required=True)
    pm.add_argument("--batch", type=int, default=4096)
    pm.add_argument("--max-frames", type=int, default=10_000_000,
                    dest="max_frames")
    pm.add_argument("--target-errors", type=int, default=100,
                    dest="target_errors")

    args = p.parse_args(argv)
    return {"codes": _cmd_codes, "simulate": _cmd_simulate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface of the PyTorch port (a subset of
`ldpc_error_floor_tpu/cli.py`):

    python -m ldpc_error_floor_tpu_torch.cli codes
    python -m ldpc_error_floor_tpu_torch.cli simulate --code wman_N0576_R34_z24 \
        --weights wman_N0576_R34_z24_boosted30 \
        --base-weights wman_N0576_R34_z24_base20 --boundary 20 --iters 30 \
        --early-stop --snrs 4.0 --batch 65536
    python -m ldpc_error_floor_tpu_torch.cli simulate ... --stop syndrome
    python -m ldpc_error_floor_tpu_torch.cli init-config --out base.json
    python -m ldpc_error_floor_tpu_torch.cli collect --config base.json \
        --weights wman_N0576_R34_z24_base20 --words 20000 --out Uncor.txt
    python -m ldpc_error_floor_tpu_torch.cli split-uncor --uncor Uncor.txt \
        --code wman_N0576_R34_z24 --train 10000 --valid 5000 --test 5000

`simulate` and `collect` print one JSON line per SNR.  They run on the card
unless ``--device cpu`` is given.
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


def _cmd_init_config(args) -> int:
    from ldpc_error_floor_tpu_torch.pipelines import (base_config_wman,
                                                      post_config_wman)
    cfg = post_config_wman() if args.post else base_config_wman()
    cfg.to_json(args.out)
    print(f"wrote {args.out}")
    return 0


def _cmd_collect(args) -> int:
    from ldpc_error_floor_tpu_torch.pipelines import (ExperimentConfig,
                                                      run_collection)
    cfg = ExperimentConfig.from_json(args.config)
    words = run_collection(cfg, weight_file=args.weights,
                           target_words=args.words, batch=args.batch,
                           out_file=args.out, max_frames=args.max_frames,
                           ckpt_path=args.ckpt, device=args.device)
    print(json.dumps({"snr_db": cfg.snrs[0], "words": int(words.shape[0]),
                      "out": args.out}))
    return 0


def _cmd_split_uncor(args) -> int:
    from ldpc_error_floor_tpu_torch.pipelines import split_uncor_dataset
    split_uncor_dataset(args.uncor, args.code, args.input_dir,
                        args.train, args.valid, args.test)
    print(f"split {args.uncor} into {args.input_dir}/[Uncor]_{args.code}*")
    return 0


def _cmd_simulate(args) -> int:
    import torch

    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec,
                                                   compose_boosted_params,
                                                   init_weights, load_params)
    from ldpc_error_floor_tpu_torch.sim import FERSimulator

    code = get_code(args.code)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=tuple(args.sharing), n_iters=args.iters,
                      fixed_iter=args.fixed_iter)
    target = (code.N - code.M) if args.systematic else 0
    dec = NMSDecoder(code, DecoderConfig(decoding_type=args.decoding_type,
                                         q_bit=args.q_bit,
                                         neural_mode=args.neural_mode,
                                         target_node=target,
                                         early_stop=args.early_stop),
                     spec, graph=graph, device=args.device)
    if args.weights:
        params = load_params(spec, graph, args.weights, device=args.device)
    else:
        params = init_weights(spec, graph, device=args.device)
    if args.base_weights:
        # boosted composition: iterations [0, boundary) take the base
        # stage's rows
        boundary = args.boundary or args.fixed_iter
        if not 0 < boundary <= args.iters:
            raise SystemExit("--base-weights needs --boundary (or "
                             "--fixed-iter) in (0, iters]")
        base_spec = WeightSpec(sharing=tuple(args.base_sharing or args.sharing),
                               n_iters=boundary)
        base_params = load_params(base_spec, graph, args.base_weights,
                                  device=args.device)
        params = compose_boosted_params(graph, base_spec, base_params, spec,
                                        params)
    ch = AWGNChannel(code, decoding_type=args.decoding_type, q_bit=args.q_bit,
                     device=args.device)
    sim = FERSimulator(dec, ch, batch=args.batch, stop=args.stop,
                       codewords=args.codewords)
    gen = torch.Generator(device=dec.device).manual_seed(args.seed)
    points = sim.run_curve(params, args.snrs, gen,
                           max_frames=args.max_frames,
                           target_frame_errors=args.target_errors,
                           ckpt_prefix=args.ckpt)
    for pt in points:
        print(json.dumps(vars(pt)))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ldpc_error_floor_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("codes", help="list bundled codes")

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; cpu runs the "
                             "plain PyTorch versions)")

    pc = sub.add_parser("init-config", help="write a template config")
    pc.add_argument("--out", default="config.json")
    pc.add_argument("--post", action="store_true",
                    help="post-decoder template (UCN, uncor data)")

    pl = sub.add_parser("collect", help="harvest uncorrected words")
    pl.add_argument("--config", required=True)
    pl.add_argument("--weights", default=None)
    pl.add_argument("--words", type=int, default=20000)
    pl.add_argument("--batch", type=int, default=4096)
    pl.add_argument("--max-frames", type=int, default=1_000_000_000,
                    dest="max_frames")
    pl.add_argument("--out", default="Uncor.txt")
    pl.add_argument("--ckpt", default=None,
                    help="JSON resume checkpoint: a killed harvest restarts "
                         "from its last counters and generator state")
    device_arg(pl)

    ps = sub.add_parser("split-uncor", help="split Uncor.txt into datasets")
    ps.add_argument("--uncor", required=True)
    ps.add_argument("--code", required=True)
    ps.add_argument("--input-dir", default="./Inputs")
    ps.add_argument("--train", type=int, required=True)
    ps.add_argument("--valid", type=int, required=True)
    ps.add_argument("--test", type=int, required=True)

    pm = sub.add_parser("simulate", help="Monte-Carlo FER curve")
    pm.add_argument("--code", required=True)
    device_arg(pm)
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("--weights", default=None,
                    help="weight file / bundled set (default: all-ones)")
    pm.add_argument("--sharing", type=int, nargs=3, default=[3, 3, 3])
    pm.add_argument("--base-weights", default=None, dest="base_weights",
                    help="boosted composition: base-stage weight set for "
                         "iterations [0, boundary)")
    pm.add_argument("--base-sharing", type=int, nargs=3, default=None,
                    dest="base_sharing")
    pm.add_argument("--boundary", type=int, default=0,
                    help="base/post boundary iteration (default: --fixed-iter)")
    pm.add_argument("--iters", type=int, default=20)
    pm.add_argument("--fixed-iter", type=int, default=0, dest="fixed_iter")
    pm.add_argument("--decoding-type", type=int, default=2, dest="decoding_type",
                    help="0 SP, 1 MS, 2 QMS, 3 MS without the zero nudge")
    pm.add_argument("--neural-mode", choices=["scale", "offset"],
                    default="scale", dest="neural_mode",
                    help="scale: multiplicative NMS weights; offset: offset "
                         "min-sum")
    pm.add_argument("--q-bit", type=int, default=5, dest="q_bit")
    pm.add_argument("--snrs", type=float, nargs="+", required=True)
    pm.add_argument("--batch", type=int, default=4096)
    pm.add_argument("--max-frames", type=int, default=10_000_000,
                    dest="max_frames")
    pm.add_argument("--target-errors", type=int, default=100,
                    dest="target_errors")
    pm.add_argument("--codewords", choices=["zero", "random"], default="zero",
                    help="random: encode fresh random messages per batch "
                         "instead of the all-zero word")
    pm.add_argument("--stop", choices=["genie", "syndrome"], default="genie",
                    help="genie: the reference's metrics (fixed iterations); "
                         "syndrome: per-frame stop at H*x = 0 (reports FER "
                         "at stop, undetected-error rate, mean iterations)")
    pm.add_argument("--early-stop", action="store_true", dest="early_stop",
                    help="genie-exact early stop of a block once all its "
                         "words have decoded")
    pm.add_argument("--ckpt", default=None,
                    help="resume-checkpoint prefix: per-SNR JSON files "
                         "{ckpt}_snr{s}.json")
    pm.add_argument("--systematic", action="store_true",
                    help="count errors over the systematic columns only")

    args = p.parse_args(argv)
    return {"codes": _cmd_codes, "init-config": _cmd_init_config,
            "collect": _cmd_collect, "split-uncor": _cmd_split_uncor,
            "simulate": _cmd_simulate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

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
    python -m ldpc_error_floor_tpu_torch.cli train --config base.json
    python -m ldpc_error_floor_tpu_torch.cli evaluate --config base.json \
        --weights Weights/C0_wman_N0576_R34_z24_Opt_Weight_End20.txt
    python -m ldpc_error_floor_tpu_torch.cli weights
    python -m ldpc_error_floor_tpu_torch.cli convert-weights --src w.txt --out w.json
    python -m ldpc_error_floor_tpu_torch.cli analyze-uncor --uncor Uncor.txt \
        --code wman_N0576_R34_z24 --weights wman_N0576_R34_z24_boosted30 --iters 30

`simulate`, `collect` and `evaluate` print one JSON line per SNR (or split);
`analyze-uncor` prints the JAX package's report text.  `train` writes the
weight files and the perf log under the config's `out_dir`.  They run on
the card unless ``--device cpu`` is given.

Data parallelism: `simulate --mesh` runs on every card of the host and
`train --mesh [--mesh-devices N]` on every card or the first N, as JAX's
`--mesh` takes every device (or the first N); more than the host has
raises ``need N devices, have M``.  The command starts one process per
card (a *rank*, NCCL between them, rank r on ``cuda:r``) and waits for
them (`parallel/launch.py`); rank 0's lines are its output, and a rank that
fails ends the others and the command.  The CPU counts as one device
(``--device cpu --mesh`` is a world of one in this process).

Across hosts, or to start the ranks by hand, each process of a world of N
is given ``--coordinator host:port --num-processes N --process-id i``
(before the subcommand), or the variables LDPC_TPU_COORDINATOR,
LDPC_TPU_NUM_PROCESSES and LDPC_TPU_PROCESS_ID; rank 0 listens at the
address and alone prints, and a card's ranks run on ``cuda:{rank %
device_count}``.  `--mesh` inside such a world (or inside a process group
this process already joined) uses it as it is:

    python -m ldpc_error_floor_tpu_torch.cli simulate --mesh --code ...
    python -m ldpc_error_floor_tpu_torch.cli --coordinator host0:29500 \
        --num-processes 16 --process-id 8 simulate --mesh --code ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_codes(args) -> int:
    from ldpc_error_floor_tpu_torch.codes import available_codes, get_code
    for name in available_codes():
        c = get_code(name)
        print(f"{name}: M={c.M} N={c.N} z={c.z} E={c.n_edges} "
              f"n={c.n} k={c.k} R={c.rate:.3f}")
    return 0


def _cmd_weights(args) -> int:
    from ldpc_error_floor_tpu_torch.io.weight_files import (available_weight_sets,
                                                            read_weight_json)
    for name in available_weight_sets():
        sharing, blocks = read_weight_json(name)
        rows = next(len(v) for v in blocks.values() if v is not None)
        print(f"{name}: sharing {sharing}, {rows} iterations")
    return 0


def _cmd_convert_weights(args) -> int:
    """Convert between the reference text format and the JSON format (both
    directions, by file extension)."""
    from ldpc_error_floor_tpu_torch.io.weight_files import (read_weight_file,
                                                            read_weight_json,
                                                            write_weight_file,
                                                            write_weight_json)
    if args.src.endswith(".json"):
        sharing, blocks = read_weight_json(args.src)
    else:
        sharing, blocks = read_weight_file(args.src)
    if args.out.endswith(".json"):
        write_weight_json(args.out, sharing, blocks)
    else:
        write_weight_file(args.out, sharing, blocks)
    print(f"converted {args.src} -> {args.out} (sharing {sharing})")
    return 0


def _cmd_analyze_uncor(args) -> int:
    """Trapping-set classification of a harvested Uncor dataset: decode it
    with the given weights and report the (a, b) failure classes and the
    most-hit variable nodes (`sim/analysis.py`)."""
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.io.uncor_files import read_uncor_file
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec, load_params)
    from ldpc_error_floor_tpu_torch.sim import classify_failures

    code = get_code(args.code)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=tuple(args.sharing), n_iters=args.iters)
    dec = NMSDecoder(code, DecoderConfig(decoding_type=args.decoding_type,
                                         q_bit=args.q_bit), spec, graph=graph,
                     device=args.device)
    params = load_params(spec, graph, args.weights, device=args.device)
    rows = read_uncor_file(args.uncor, max_rows=args.max_rows or None)
    rep = classify_failures(dec, params, rows, batch=args.batch)
    print(rep.summary(args.top))
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


def _cmd_train(args) -> int:
    from ldpc_error_floor_tpu_torch.parallel import data_mesh
    from ldpc_error_floor_tpu_torch.pipelines import (ExperimentConfig,
                                                      run_training)
    cfg = ExperimentConfig.from_json(args.config)
    mesh = data_mesh(args.mesh_devices, device=args.device) if args.mesh else None
    res = run_training(cfg, eval_batch=args.eval_batch, device=args.device,
                       mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(f"done; best metric {res.best_metric:.3e}")
    return 0


def _cmd_evaluate(args) -> int:
    """Evaluate a weight file on fresh noise or the harvested valid/test
    datasets (the four metric rows)."""
    import torch

    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.io.uncor_files import read_uncor_file
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec, load_params)
    from ldpc_error_floor_tpu_torch.pipelines import ExperimentConfig
    from ldpc_error_floor_tpu_torch.pipelines.evaluate import Evaluator

    cfg = ExperimentConfig.from_json(args.config).validate()
    code = get_code(cfg.code, z=cfg.z, punct=cfg.punct, short=cfg.short)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=cfg.sharing, n_iters=cfg.iters_max,
                      fixed_iter=cfg.fixed_iter)
    weights = args.weights or (
        f"{cfg.out_dir}/{cfg.out_prefix}_Opt_Weight_End{cfg.iters_max}.txt")
    params = load_params(spec, graph, weights, device=args.device)
    target = (code.N - code.M) if cfg.systematic else 0
    dec = NMSDecoder(code, DecoderConfig(decoding_type=cfg.decoding_type,
                                         q_bit=cfg.q_bit,
                                         clip_llr=cfg.clip_llr,
                                         neural_mode=cfg.neural_mode,
                                         target_node=target),
                     spec, graph=graph, device=args.device)
    channel = AWGNChannel(code, decoding_type=cfg.decoding_type,
                          q_bit=cfg.q_bit, clip_llr=cfg.clip_llr,
                          device=args.device)
    if cfg.sampling_type == 1:  # harvested datasets
        base = f"{cfg.input_dir}/[Uncor]_{cfg.code}"
        splits = [("valid", base + "_Valid.txt", cfg.valid_num),
                  ("test", base + "_Test.txt", cfg.test_num)]
        for name, path, num in splits:
            data = read_uncor_file(path, max_rows=num)
            rows = min(num, data.shape[0])
            # a split smaller than --batch still evaluates; a trailing
            # remainder that fills no batch is reported
            eb = min(args.batch, rows)
            used = (rows // eb) * eb
            if used < rows:
                print(f"# {name}: evaluating {used}/{rows} rows "
                      f"({rows - used} trailing rows don't fill a batch "
                      f"of {eb})", flush=True)
            ev = Evaluator(dec, channel, cfg.loss_type, batch=eb)
            res, dt = ev.run(params, [0.0], used, cfg.etha_start, data=data)
            print(json.dumps({"split": name, "ber_last": res[0, 0],
                              "fer_last": res[1, 0], "fer": res[2, 0],
                              "loss": res[3, 0], "seconds": dt,
                              "rows_used": used}))
    else:
        ev = Evaluator(dec, channel, cfg.loss_type, batch=args.batch)
        gen = torch.Generator(device=dec.device).manual_seed(cfg.seed)
        res, dt = ev.run(params, code.snr_sigmas(cfg.snrs), args.frames,
                         cfg.etha_start, generator=gen)
        for i, snr in enumerate(cfg.snrs):
            print(json.dumps({"snr": snr, "ber_last": res[0, i],
                              "fer_last": res[1, i], "fer": res[2, i],
                              "loss": res[3, i]}))
    return 0


def _cmd_simulate(args) -> int:
    import torch

    from ldpc_error_floor_tpu_torch.channel import AWGNChannel
    from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
    from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                   WeightSpec,
                                                   compose_boosted_params,
                                                   init_weights, load_params)
    from ldpc_error_floor_tpu_torch.parallel import data_mesh
    from ldpc_error_floor_tpu_torch.sim import FERSimulator

    mesh = data_mesh(device=args.device) if args.mesh else None
    device = args.device if mesh is None else mesh.device
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
                     spec, graph=graph, device=device)
    if args.weights:
        params = load_params(spec, graph, args.weights, device=device)
    else:
        params = init_weights(spec, graph, device=device)
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
                                  device=device)
        params = compose_boosted_params(graph, base_spec, base_params, spec,
                                        params)
    ch = AWGNChannel(code, decoding_type=args.decoding_type, q_bit=args.q_bit,
                     device=device)
    sim = FERSimulator(dec, ch, batch=args.batch, stop=args.stop,
                       codewords=args.codewords, inner_steps=args.inner_steps,
                       mesh=mesh)
    gen = torch.Generator(device=dec.device).manual_seed(args.seed)
    points = sim.run_curve(params, args.snrs, gen,
                           max_frames=args.max_frames,
                           target_frame_errors=args.target_errors,
                           ckpt_prefix=args.ckpt)
    if mesh is None or mesh.rank == 0:
        for pt in points:
            print(json.dumps(vars(pt)))
    return 0


def _coordinator(args):
    return args.coordinator or os.environ.get("LDPC_TPU_COORDINATOR")


def _init_distributed(args) -> None:
    """Join the world given by the flags or the LDPC_TPU_COORDINATOR /
    LDPC_TPU_NUM_PROCESSES / LDPC_TPU_PROCESS_ID variables; nothing without
    a coordinator."""
    from ldpc_error_floor_tpu_torch.parallel import initialize_distributed
    coord = _coordinator(args)
    if not coord:
        return
    nprocs = args.num_processes
    if nprocs is None and os.environ.get("LDPC_TPU_NUM_PROCESSES"):
        nprocs = int(os.environ["LDPC_TPU_NUM_PROCESSES"])
    pid = args.process_id
    if pid is None and os.environ.get("LDPC_TPU_PROCESS_ID"):
        pid = int(os.environ["LDPC_TPU_PROCESS_ID"])
    initialize_distributed(coord, nprocs, pid,
                           device=getattr(args, "device", "cuda"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ldpc_error_floor_tpu_torch")
    p.add_argument("--coordinator", default=None,
                   help="data parallelism: rank 0's address host:port (or "
                        "env LDPC_TPU_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None,
                   dest="num_processes",
                   help="ranks in the world (or env LDPC_TPU_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None, dest="process_id",
                   help="this process's rank (or env LDPC_TPU_PROCESS_ID)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("codes", help="list bundled codes")
    sub.add_parser("weights", help="list bundled trained weight sets")

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; cpu runs the "
                             "plain PyTorch versions)")

    pw = sub.add_parser("convert-weights",
                        help="convert weight files text<->json by extension")
    pw.add_argument("--src", required=True)
    pw.add_argument("--out", required=True)

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

    pt = sub.add_parser("train", help="train a decoder (base or post)")
    pt.add_argument("--config", required=True)
    pt.add_argument("--eval-batch", type=int, default=None, dest="eval_batch")
    pt.add_argument("--mesh", action="store_true",
                    help="data-parallel training over every card, one rank "
                         "each: each rank trains on its lanes of every batch "
                         "(parameters replicated, gradients averaged over "
                         "the ranks)")
    pt.add_argument("--mesh-devices", type=int, default=None,
                    dest="mesh_devices",
                    help="use only the first N cards (inside a world started "
                         "by hand: its size, checked)")
    device_arg(pt)

    pe = sub.add_parser("evaluate",
                        help="evaluate weights on fresh noise or the "
                             "harvested valid/test datasets (4 metric rows)")
    pe.add_argument("--config", required=True)
    pe.add_argument("--weights", default=None,
                    help="weight file / bundled set (default: the config's "
                         "Opt_Weight_End{iters_max}.txt)")
    pe.add_argument("--batch", type=int, default=1000)
    pe.add_argument("--frames", type=int, default=10000,
                    help="frames per SNR for fresh-noise evaluation")
    device_arg(pe)

    pa = sub.add_parser("analyze-uncor",
                        help="trapping-set (a,b) classification of a "
                             "harvested Uncor dataset")
    pa.add_argument("--uncor", required=True)
    pa.add_argument("--code", required=True)
    pa.add_argument("--weights", required=True)
    pa.add_argument("--sharing", type=int, nargs=3, default=[3, 3, 3])
    pa.add_argument("--iters", type=int, default=20)
    pa.add_argument("--decoding-type", type=int, default=2,
                    dest="decoding_type")
    pa.add_argument("--q-bit", type=int, default=5, dest="q_bit")
    pa.add_argument("--batch", type=int, default=1024)
    pa.add_argument("--max-rows", type=int, default=0, dest="max_rows")
    pa.add_argument("--top", type=int, default=10)
    device_arg(pa)

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
    pm.add_argument("--inner-steps", type=int, default=1, dest="inner_steps",
                    help="batches per host read, run as one CUDA graph "
                         "replay on the card")
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
    pm.add_argument("--mesh", action="store_true",
                    help="data-parallel Monte-Carlo over every card, one rank "
                         "each: each rank decodes its lanes of every batch, "
                         "the counters are summed")

    args = p.parse_args(argv)
    import torch
    import torch.distributed as dist
    joined = dist.is_initialized()
    if getattr(args, "mesh", False) and not joined and not _coordinator(args):
        # one world over the host's devices: on a card, a rank per card
        from ldpc_error_floor_tpu_torch.parallel import mesh_world, spawn_ranks
        world = mesh_world(getattr(args, "mesh_devices", None), args.device)
        if torch.device(args.device).type == "cuda":
            return spawn_ranks(sys.argv[1:] if argv is None else list(argv), world,
                               args.device)
    _init_distributed(args)
    try:
        return {"codes": _cmd_codes, "weights": _cmd_weights,
                "convert-weights": _cmd_convert_weights,
                "analyze-uncor": _cmd_analyze_uncor,
                "init-config": _cmd_init_config, "train": _cmd_train,
                "evaluate": _cmd_evaluate, "collect": _cmd_collect,
                "split-uncor": _cmd_split_uncor,
                "simulate": _cmd_simulate}[args.cmd](args)
    finally:
        # the process group this call made (the flags' or `--mesh`'s)
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

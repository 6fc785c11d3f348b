"""Training pipeline (port of `ldpc_error_floor_tpu/pipelines/train.py`): the
reference's `main_Base.py` / `main_Post.py` epoch and block loops.

* block-wise Delta1/Delta2 schedule with the frozen prefix loaded from the
  previous block's best weights (`{prefix}_Opt_Weight_End{start}.txt`);
* per epoch: train steps (epoch 0 evaluates the initialization only),
  weight-file dump, best-on-valid copy by the configured metric, perf log,
  eta and learning-rate step decays, and with `checkpoint_every` a
  full-state snapshot that `resume` restores;
* data sources: mixed-SNR AWGN lanes (sampling_type 0, random codewords
  with ``train_on_zero_word = 0``) or a harvested uncorrected-word dataset
  (sampling_type 1, the post-decoder path).

All sampling draws from one `torch.Generator` on the device, seeded with
`cfg.seed`: weight init (init value -1), each epoch's batches, each
evaluation.  With eta identically zero the training decoder windows its APP
stack to the last iteration (``app_t0 = end - 1``), the loss its last
iteration.  On the card the steps run through the CUDA pair B4/B5 and the
evaluation through B4 (with the loss) or B1; a failure raises — there is no
other backend to fall back to.

With a mesh (`parallel.mesh`) every rank runs this loop in step: each draws
the whole global batch from the generator every rank holds in the same
state and trains on its own lanes (gradients averaged over the ranks), so a
world of W trains on the numbers a world of one trains on.  Rank 0 alone
writes the weight files, the perf log and the resume snapshots, on a file
system every rank reads; every rank reads them back.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel, mix_sigma_lanes
from ldpc_error_floor_tpu_torch.codes import Code, TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io.perflog import PerfLog
from ldpc_error_floor_tpu_torch.io.uncor_files import read_uncor_file
from ldpc_error_floor_tpu_torch.io.weight_files import (read_weight_file,
                                                        write_weight_file)
from ldpc_error_floor_tpu_torch.models.nms import DecoderConfig, NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import (WeightSpec, init_weights,
                                                       params_from_blocks,
                                                       params_to_blocks,
                                                       partial_update_from_blocks)
from ldpc_error_floor_tpu_torch.parallel.mesh import DataMesh, barrier, replicate
from ldpc_error_floor_tpu_torch.pipelines.config import (ExperimentConfig,
                                                         SAMPLING_COLLECT,
                                                         SAMPLING_READ_UNCOR)
from ldpc_error_floor_tpu_torch.pipelines.evaluate import Evaluator
from ldpc_error_floor_tpu_torch.training.checkpoint import (block_ckpt_dir,
                                                            restore_train_state,
                                                            save_train_state)
from ldpc_error_floor_tpu_torch.training.schedule import training_blocks
from ldpc_error_floor_tpu_torch.training.train import (make_epoch_step,
                                                       make_optimizer,
                                                       set_learning_rate)
from ldpc_error_floor_tpu_torch.utils import resolve_device


@dataclass
class TrainResult:
    params: dict
    spec: WeightSpec
    best_metric: float
    history: List[dict] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)  # CUDA kernel
    #   launches of the run by kernel name (none on the CPU)


def _load_code(cfg: ExperimentConfig) -> Code:
    return get_code(cfg.code, z=cfg.z, punct=cfg.punct, short=cfg.short)


def _load_uncor_data(cfg: ExperimentConfig):
    """The harvested train / valid / test datasets of sampling_type 1."""
    base = os.path.join(cfg.input_dir, f"[Uncor]_{cfg.code}")
    train = read_uncor_file(base + ".txt", max_rows=cfg.training_num)
    valid = (read_uncor_file(base + "_Valid.txt", max_rows=cfg.valid_num)
             if cfg.valid_flag else None)
    test = (read_uncor_file(base + "_Test.txt", max_rows=cfg.test_num)
            if cfg.test_flag else None)
    return train, valid, test


def _opt_metric_value(results: np.ndarray, opt_metric: int) -> float:
    """Sum over SNRs of the selected metric row."""
    return float(results[opt_metric].sum())


def run_training(cfg: ExperimentConfig, verbose: bool = True,
                 eval_batch: Optional[int] = None,
                 device="cuda", mesh: Optional[DataMesh] = None) -> TrainResult:
    """Train every block of `cfg`'s schedule; returns the last block's
    parameters and best valid metric.  Writes the weight files, the perf log
    and (with `checkpoint_every`) the resume snapshots under `cfg.out_dir`.
    With `mesh` the run is data-parallel on the mesh's device (the batch
    sizes must divide by the world's size)."""
    cfg = cfg.validate()
    if mesh is not None and cfg.batch_size % mesh.world:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by the "
                         f"mesh's {mesh.world} ranks")
    dev = resolve_device(device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
    code = _load_code(cfg)
    graph = TannerGraph(code)
    target_node = (code.N - code.M) if cfg.systematic else 0
    os.makedirs(cfg.out_dir, exist_ok=True)
    prefix = os.path.join(cfg.out_dir, cfg.out_prefix)
    log = PerfLog(prefix + "_Performance.txt" if writer else os.devnull,
                  echo=verbose and writer)
    log.header(cfg)

    channel = AWGNChannel(code, decoding_type=cfg.decoding_type,
                          q_bit=cfg.q_bit, clip_llr=cfg.clip_llr, device=dev)
    snr_sigmas = code.snr_sigmas(cfg.snrs)
    train_sigmas = torch.as_tensor(mix_sigma_lanes(snr_sigmas, cfg.batch_size),
                                   device=dev)

    data_train = data_valid = data_test = None
    if cfg.sampling_type == SAMPLING_READ_UNCOR:
        data_train, data_valid, data_test = _load_uncor_data(cfg)

    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    result: Optional[TrainResult] = None
    launches: collections.Counter = collections.Counter()

    for start, end in training_blocks(cfg.iters_max, cfg.fixed_iter,
                                      cfg.iter_step):
        spec = WeightSpec(sharing=cfg.sharing, n_iters=end,
                          fixed_iter=cfg.fixed_iter,
                          min_w=cfg.min_weight, max_w=cfg.max_weight)
        params = init_weights(spec, graph, cfg.init_weight, cfg.init_vn_weight,
                              generator=generator, device=dev)
        if cfg.init_from_file:
            in_file = f"{prefix}_In_Weight_End{cfg.iters_max}.txt"
            sharing_f, blocks = read_weight_file(in_file)
            if tuple(sharing_f) != tuple(cfg.sharing):
                raise ValueError(f"{in_file}: sharing mismatch")
            params = params_from_blocks(spec, blocks, graph, device=dev)
        if start > 0:
            frozen_file = f"{prefix}_Opt_Weight_End{start}.txt"
            _, blocks = read_weight_file(frozen_file)
            params = partial_update_from_blocks(spec, params, blocks, start,
                                                graph)
        params = replicate(mesh, params)

        dcfg = DecoderConfig(decoding_type=cfg.decoding_type, q_bit=cfg.q_bit,
                             clip_llr=cfg.clip_llr, target_node=target_node,
                             neural_mode=cfg.neural_mode)
        # eta identically zero (the recipe's default): the loss reads only
        # the last iteration, so the training decoder emits only its APPs;
        # 0 times a discount stays 0, so the decay never changes that
        static_etha = 0.0 if cfg.etha_start == 0.0 else None
        train_cfg = (dataclasses.replace(dcfg, app_t0=end - 1)
                     if static_etha == 0.0 else dcfg)
        decoder = NMSDecoder(code, train_cfg, spec, graph=graph, device=dev)
        optimizer = make_optimizer(params, cfg.learn_rate_start)
        t_lo = max(start - cfg.fixed_init, cfg.fixed_iter)
        eb = eval_batch or cfg.batch_size
        need_loss = bool(cfg.eval_loss) or cfg.opt_metric == 3
        eval_decoder = NMSDecoder(code, dcfg, spec, graph=graph, device=dev)
        evaluator = Evaluator(eval_decoder, channel, cfg.loss_type, t_lo=t_lo,
                              batch=eb, compute_loss=need_loss, mesh=mesh)
        nbits = decoder.target * code.z
        labels = torch.zeros((nbits, cfg.batch_size), dtype=torch.float32,
                             device=dev)
        n_train_batches = cfg.training_num // cfg.batch_size
        data_mode = cfg.sampling_type == SAMPLING_READ_UNCOR
        encoder = None
        if not cfg.train_on_zero_word:
            from ldpc_error_floor_tpu_torch.codes.encoder import Encoder
            encoder = Encoder(graph, device=dev)
        epoch_step = make_epoch_step(
            decoder, spec, cfg.loss_type, start, end, cfg.fixed_init,
            n_steps=n_train_batches, labels=labels, channel=channel,
            sigmas=train_sigmas, data_mode=data_mode, encoder=encoder,
            static_etha=static_etha, mesh=mesh)
        data_train_dev = None
        if data_mode:
            data_train_dev = torch.as_tensor(
                data_train[:n_train_batches * cfg.batch_size], device=dev)

        etha_curr = cfg.etha_start
        lr_curr = cfg.learn_rate_start
        opt_valid = opt_test = 1e5
        best_metric = 1e5
        history: List[dict] = []

        # full-state checkpoint / resume
        first_epoch = 0
        ckpt_dir = block_ckpt_dir(cfg.out_dir, cfg.out_prefix, start, end)
        if cfg.resume:
            restored = restore_train_state(ckpt_dir, params, optimizer, generator)
            if restored is not None:
                first_epoch = restored["epoch"] + 1
                extra = restored["extra"]
                etha_curr = float(extra.get("etha", etha_curr))
                lr_curr = float(extra.get("lr", lr_curr))
                opt_valid = float(extra.get("opt_valid", opt_valid))
                best_metric = opt_valid
                if verbose:
                    print(f"resumed block [{start},{end}) at epoch {first_epoch}")

        for epoch in range(first_epoch, cfg.epochs + 1):
            t0 = time.perf_counter()
            avg_loss = 0.0
            if (epoch > 0 and cfg.sampling_type != SAMPLING_COLLECT
                    and n_train_batches > 0):
                set_learning_rate(optimizer, lr_curr)
                source = data_train_dev if data_mode else generator
                avg_loss = float(epoch_step(params, optimizer, source, etha_curr))
            t_train = time.perf_counter() - t0

            # dump weights + train log
            if writer:
                write_weight_file(f"{prefix}_Weight_End{end}.txt", cfg.sharing,
                                  params_to_blocks(spec, params))
            log.train_result(epoch, cfg.epochs, start, end, avg_loss)

            # validation (in collect mode also the harvesting pass)
            t_valid = t_test = 0.0
            uncor_path = (os.path.join(cfg.out_dir, "Uncor.txt")
                          if cfg.sampling_type == SAMPLING_COLLECT else None)
            if cfg.valid_flag:
                results, t_valid = evaluator.run(
                    params, snr_sigmas, cfg.valid_num, etha_curr,
                    generator=generator, data=data_valid,
                    collect_uncor_path=uncor_path)
                metric = _opt_metric_value(results, cfg.opt_metric)
                improved = metric < opt_valid
                if improved:
                    opt_valid = metric
                    if writer:
                        shutil.copyfile(f"{prefix}_Weight_End{end}.txt",
                                        f"{prefix}_Opt_Weight_End{end}.txt")
                best_metric = opt_valid
                log.eval_result("Valid", results, opt_valid)
                history.append({"epoch": epoch, "block": (start, end),
                                "train_loss": avg_loss,
                                "valid": results.tolist(),
                                "metric": metric, "improved": improved})

            if (cfg.sampling_type == SAMPLING_READ_UNCOR and cfg.test_flag
                    and data_test is not None):
                results_t, t_test = evaluator.run(
                    params, snr_sigmas, cfg.test_num, etha_curr,
                    generator=generator, data=data_test)
                opt_test = min(opt_test,
                               _opt_metric_value(results_t, cfg.opt_metric))
                log.eval_result("Test", results_t, opt_test)

            log.timing(t_train, t_valid, t_test)

            # step decays
            if cfg.etha_discount and cfg.etha_discount_step and \
                    (epoch + 1) % cfg.etha_discount_step == 0:
                etha_curr *= cfg.etha_discount
            if cfg.learn_rate_discount and cfg.learn_rate_step and \
                    (epoch + 1) % cfg.learn_rate_step == 0:
                lr_curr *= cfg.learn_rate_discount

            if cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0 \
                    and writer:
                save_train_state(ckpt_dir, epoch, params, optimizer, generator,
                                 extra={"etha": etha_curr, "lr": lr_curr,
                                        "opt_valid": opt_valid})

        # an Opt file exists even without validation
        if not cfg.valid_flag and writer:
            shutil.copyfile(f"{prefix}_Weight_End{end}.txt",
                            f"{prefix}_Opt_Weight_End{end}.txt")
        barrier(mesh)  # rank 0's files are written before any rank reads them
        for d in (decoder, eval_decoder):
            launches.update(d.kernel.launches)
            launches.update(d.train_kernel.launches)
        launches.update(channel.launches)  # the one channel of every block
        channel.launches.clear()
        result = TrainResult(params={k: None if v is None else v.detach()
                                     for k, v in params.items()},
                             spec=spec, best_metric=best_metric,
                             history=history, launches=dict(launches))

    return result

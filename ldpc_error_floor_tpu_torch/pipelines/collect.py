"""Uncorrected-word collection driver (port of
`ldpc_error_floor_tpu/pipelines/collect.py`): decode fresh noise at one SNR
with frozen weights and append every never-corrected frame to an Uncor
file, through `sim.harvest.UncorHarvester` with the genie early stop on (at
error-floor SNRs most blocks converge long before the last iteration)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code
from ldpc_error_floor_tpu_torch.io.uncor_files import (append_uncor_file,
                                                       read_uncor_file)
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                               WeightSpec, load_params)
from ldpc_error_floor_tpu_torch.parallel.mesh import DataMesh
from ldpc_error_floor_tpu_torch.pipelines.config import ExperimentConfig
from ldpc_error_floor_tpu_torch.sim.harvest import UncorHarvester


def run_collection(cfg: ExperimentConfig, weight_file: Optional[str] = None,
                   target_words: int = 20000, batch: int = 4096,
                   out_file: str = "Uncor.txt",
                   max_frames: int = 1_000_000_000,
                   ckpt_path: Optional[str] = None,
                   device="cuda", mesh: Optional[DataMesh] = None) -> np.ndarray:
    """Collect `target_words` uncorrected words at cfg.snrs[0]; returns them
    [num, N*z] and appends them to `out_file`.

    `weight_file` defaults to the trained base decoder's best snapshot
    ({out_dir}/{prefix}_Opt_Weight_End{iters_max}.txt).  With `mesh` the
    batch is global and every rank harvests on its mesh device; in a world
    of W > 1 each appends to ``{out_file}.part{rank}`` and returns its own
    words (`UncorHarvester`)."""
    cfg = cfg.validate()
    if mesh is not None:
        device = mesh.device
    if len(cfg.snrs) != 1:
        raise ValueError("collection runs at a single SNR")
    code = get_code(cfg.code, z=cfg.z, punct=cfg.punct, short=cfg.short)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=cfg.sharing, n_iters=cfg.iters_max,
                      fixed_iter=cfg.fixed_iter, min_w=cfg.min_weight,
                      max_w=cfg.max_weight)
    if weight_file is None:
        weight_file = os.path.join(
            cfg.out_dir, f"{cfg.out_prefix}_Opt_Weight_End{cfg.iters_max}.txt")
    params = load_params(spec, graph, weight_file, device=device)
    target = (code.N - code.M) if cfg.systematic else 0
    dcfg = DecoderConfig(decoding_type=cfg.decoding_type, q_bit=cfg.q_bit,
                         clip_llr=cfg.clip_llr, neural_mode=cfg.neural_mode,
                         target_node=target, early_stop=True)
    decoder = NMSDecoder(code, dcfg, spec, graph=graph, device=device)
    channel = AWGNChannel(code, decoding_type=cfg.decoding_type,
                          q_bit=cfg.q_bit, clip_llr=cfg.clip_llr, device=device)
    harvester = UncorHarvester(decoder, channel, batch=batch, mesh=mesh)
    generator = torch.Generator(device=decoder.device).manual_seed(cfg.seed)
    return harvester.collect(params, cfg.snrs[0], generator, target_words,
                             max_frames=max_frames, out_file=out_file,
                             ckpt_path=ckpt_path)


def split_uncor_dataset(uncor_file: str, code_name: str, input_dir: str,
                        n_train: int, n_valid: int, n_test: int) -> None:
    """Split a harvested Uncor.txt into the three `[Uncor]_{code}` datasets
    the post-decoder training expects."""
    llrs = read_uncor_file(uncor_file)
    need = n_train + n_valid + n_test
    if llrs.shape[0] < need:
        raise ValueError(f"{uncor_file}: {llrs.shape[0]} rows < {need}")
    os.makedirs(input_dir, exist_ok=True)
    base = os.path.join(input_dir, f"[Uncor]_{code_name}")
    splits = [(".txt", llrs[:n_train]),
              ("_Valid.txt", llrs[n_train:n_train + n_valid]),
              ("_Test.txt", llrs[n_train + n_valid:need])]
    for suffix, rows in splits:
        path = base + suffix
        if os.path.exists(path):
            os.remove(path)
        append_uncor_file(path, rows)

"""Uncorrected-word harvesting (port of `ldpc_error_floor_tpu/sim/harvest.py`).

Decode fresh noise at one SNR and keep every frame whose genie flag says it
was wrong at *every* iteration; those LLR frames become the post decoder's
training set.  The frames that failed are compacted on the device into a
fixed capacity (`torch.nonzero_static`), so the host reads one count per
batch plus at most `cap` LLR columns, and only when there were hits.

Under a mesh each rank harvests its own lanes from its `rank_generator`
and, in a world of W > 1, appends to ``{out_file}.part{rank}`` and keeps
``{ckpt_path}.part{rank}``.  The stop reads the words kept by every rank
(one `all_reduce` per batch), so every rank leaves on the same batch; JAX's
loop stops each process on its own count.

Under a profiler `collect` records host spans (`utils.profiling.annotate`):
``ldpc.harvest.step`` (a batch enqueued), ``ldpc.harvest.read`` (its count
and kept rows read back to the host) and ``ldpc.harvest.ckpt``.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel
from ldpc_error_floor_tpu_torch.io.uncor_files import append_uncor_file
from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import Params
from ldpc_error_floor_tpu_torch.parallel.mesh import (DataMesh, all_sum,
                                                      rank_generator)
from ldpc_error_floor_tpu_torch.sim.fer import (_save_ckpt, generator_state,
                                                part_path, resume_ckpt,
                                                set_generator_state)
from ldpc_error_floor_tpu_torch.utils.profiling import annotate


def _truncate_rows(path: str, n_rows: int) -> None:
    """Truncate a text file to its first `n_rows` lines, in place."""
    keep = 0
    with open(path, "rb") as f:
        for _ in range(n_rows):
            line = f.readline()
            if not line:
                break
            keep += len(line)
    with open(path, "r+b") as f:
        f.truncate(keep)


class UncorHarvester:
    """Harvests never-corrected frames at one SNR.

    `cap` bounds how many failing frames are kept per batch (per rank
    under a mesh); a batch with more hits than `cap` keeps the first `cap`
    (the true count is still reported in `hits`, so overflow shows in the
    accounting).  Under a mesh `batch` is global.
    """

    def __init__(self, decoder: NMSDecoder, channel: AWGNChannel,
                 batch: int = 1024, cap: int = 512,
                 mesh: Optional[DataMesh] = None):
        if decoder.device.type != channel.device.type:
            raise ValueError(f"decoder on {decoder.device}, channel on "
                             f"{channel.device}")
        if mesh is not None and batch % mesh.world:
            raise ValueError(f"batch {batch} not divisible by the mesh's "
                             f"{mesh.world} ranks")
        self.decoder = decoder
        self.channel = channel
        self.batch = batch
        self.mesh = mesh
        self.local_batch = batch if mesh is None else batch // mesh.world
        self.cap = cap
        self.frames = 0  # frames decoded by the last `collect`, resumed ones
        self.hits = 0    # too, and the failing frames it found, kept or not
        #                  (by every rank)

    def _step(self, params: Params, generator: torch.Generator, sigma: float):
        """(count of failing frames [] int64, their first `cap` LLR
        columns [N*z, cap]) of one batch, on the device."""
        sig = torch.full((self.local_batch,), sigma, dtype=torch.float32,
                         device=self.decoder.device)
        llr = self.channel.sample(generator, sig)
        mask = self.decoder.apply(params, llr, collect="counts").uncor_mask
        idx = torch.nonzero_static(mask, size=self.cap,
                                   fill_value=self.local_batch - 1)[:, 0]
        return mask.sum(dtype=torch.int64), llr[:, idx]

    def collect(self, params: Params, snr_db: float,
                generator: torch.Generator, target_words: int,
                max_frames: int = 1_000_000_000,
                out_file: Optional[str] = None,
                log_every: Optional[int] = None,
                ckpt_path: Optional[str] = None,
                ckpt_every_s: float = 60.0) -> np.ndarray:
        """Harvest at one SNR until `target_words` failures or `max_frames`
        frames; returns the harvested LLRs [num, N*z] (p1/p0) and, with
        `out_file`, appends them there in the Uncor format.

        `ckpt_path`: JSON resume file.  The counters, the generator state
        and the row count of `out_file` are checkpointed after a batch's hits
        are appended; a resumed run first truncates `out_file` back to the
        checkpoint's row count, so batches appended after the last
        checkpoint (which the resumed generator draws again) are never
        duplicated.  The returned array then holds only the words found
        since the resume (the rest are already in `out_file`).

        Under a mesh `target_words`, `max_frames` and the counters are
        global; the array holds this rank's words."""
        sigma = float(np.float32(self.channel.code.snr_sigmas([snr_db])[0]))
        words: List[np.ndarray] = []
        n_words = frames = hits = 0
        file_rows = 0
        out_file = part_path(out_file, self.mesh)
        if out_file is not None and os.path.exists(out_file):
            with open(out_file, "rb") as f:
                file_rows = sum(1 for _ in f)
        ckpt_path, resumed = resume_ckpt(ckpt_path, snr_db, self.mesh)
        generator = rank_generator(generator, self.mesh)
        if resumed is not None:
            n_words, frames = int(resumed["n_words"]), int(resumed["frames"])
            hits = int(resumed.get("hits", n_words))
            set_generator_state(generator, resumed["generator_state"])
            ck_rows = resumed.get("file_rows")
            if out_file is not None and ck_rows is not None \
                    and file_rows > int(ck_rows):
                _truncate_rows(out_file, int(ck_rows))
                file_rows = int(ck_rows)
        t0 = time.perf_counter()
        t_ckpt = t0
        world = 1 if self.mesh is None else self.mesh.world
        while n_words < target_words and frames < max_frames:
            with annotate("ldpc.harvest.step"):
                count, picked = self._step(params, generator, sigma)
            frames += self.batch
            with annotate("ldpc.harvest.read"):
                c = int(count)
                kept = min(c, self.cap)
                got = picked[:, :kept].T.cpu().numpy() if kept else None
            if kept:
                words.append(got)
                if out_file is not None:
                    append_uncor_file(out_file, got)
                    file_rows += kept
            due = bool(ckpt_path) and time.perf_counter() - t_ckpt >= ckpt_every_s
            if self.mesh is not None:  # every rank's words; any rank's timer
                kept, c, due = all_sum(self.mesh, torch.tensor(
                    [kept, c, int(due)], device=self.mesh.device)).tolist()
            n_words += kept
            hits += c
            if due:
                t_ckpt = time.perf_counter()
                # the generator now regenerates everything after this batch,
                # whose hits are already appended on disk
                with annotate("ldpc.harvest.ckpt"):
                    _save_ckpt(ckpt_path, {"snr_db": float(snr_db),
                                           "frames": frames, "n_words": n_words,
                                           "hits": hits, "file_rows": file_rows,
                                           "generator_state": generator_state(generator),
                                           "world": world})
            if log_every and frames % log_every == 0 and (
                    self.mesh is None or self.mesh.rank == 0):
                dt = time.perf_counter() - t0
                print(f"harvest: {n_words}/{target_words} words, "
                      f"{frames} frames, {frames / dt:.0f} fps")
        self.frames, self.hits = frames, hits
        if not words:
            return np.zeros((0, self.channel.code.n_full), np.float32)
        return np.concatenate(words, axis=0)

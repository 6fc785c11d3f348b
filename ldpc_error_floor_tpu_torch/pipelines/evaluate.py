"""Epoch evaluator (port of `ldpc_error_floor_tpu/pipelines/evaluate.py`).

Per SNR point, decodes `sample_num` frames (fresh AWGN noise, or batches of
a harvested uncorrected-word dataset) and accumulates the four metric rows
BER_last / FER_last / genie-FER / loss.  Optionally appends every
never-corrected frame to an Uncor file (the collection path).

With `compute_loss` the decoder's APP stack of all T iterations comes from
the training forward B4 under ``torch.no_grad`` (the decoder must not window
its APPs: ``app_t0 = 0``); without it, from the stats kernel B1 (the loss row
then reads 0; all-zero labels).  Batch counters stay on the device until
the end of a run; the host then reduces them in float64, as the reference's
NumPy accumulation does.

Under a mesh `batch` is global: every rank draws the whole batch (or reads
the rows) and decodes its own lanes; the counters are summed and the loss
averaged over the ranks once per run, and in collect mode rank 0 writes the
words every rank flagged, in lane order, to the one Uncor file.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel
from ldpc_error_floor_tpu_torch.io.uncor_files import append_uncor_file
from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import Params
from ldpc_error_floor_tpu_torch.parallel.mesh import (DataMesh, all_sum,
                                                      batch_constraint,
                                                      gather_lanes)
from ldpc_error_floor_tpu_torch.training.losses import multi_iteration_loss


class Evaluator:
    def __init__(self, decoder: NMSDecoder, channel: AWGNChannel,
                 loss_type: int, t_lo: int = 0, batch: int = 0,
                 compute_loss: bool = True, mesh: Optional[DataMesh] = None):
        if compute_loss and decoder.cfg.app_t0:
            raise ValueError("the loss needs every iteration's APPs: "
                             "evaluate with a decoder whose app_t0 is 0")
        if mesh is not None and batch % mesh.world:
            raise ValueError(f"batch {batch} not divisible by the mesh's "
                             f"{mesh.world} ranks")
        self.decoder = decoder
        self.mesh = mesh
        self.channel = channel
        self.batch = batch
        self.loss_type = loss_type
        self.t_lo = t_lo
        self.compute_loss = compute_loss

    @torch.no_grad()
    def _metrics(self, params: Params, llr: torch.Tensor,
                 labels: torch.Tensor, etha: float):
        """(int64 [be_last, fe_last, fe_genie], loss, uncor [B]) of a batch."""
        if not self.compute_loss:
            res = self.decoder.apply(params, llr, collect="stats")
            uncor = res.uncor_mask
            ints = torch.stack([res.bit_errors[-1].sum(dtype=torch.int64),
                                res.err_flags[-1].sum(dtype=torch.int64),
                                uncor.sum(dtype=torch.int64)])
            return ints, torch.zeros((), device=llr.device), uncor
        apps = self.decoder.apply(params, llr, collect="apps").apps
        wrong = (apps >= 0) != (labels[None] >= 0.5)       # [T, tz, B]
        err_t = wrong.any(dim=1)                            # [T, B]
        uncor = err_t.all(dim=0)                            # [B]
        ints = torch.stack([wrong[-1].sum(dtype=torch.int64),
                            err_t[-1].sum(dtype=torch.int64),
                            uncor.sum(dtype=torch.int64)])
        loss = multi_iteration_loss(apps, labels, self.loss_type, float(etha),
                                    t_start=self.t_lo)
        return ints, loss, uncor

    def run(self, params: Params, snr_sigmas, sample_num: int, etha: float,
            generator: Optional[torch.Generator] = None,
            data: Optional[np.ndarray] = None,
            collect_uncor_path: Optional[str] = None):
        """Returns (results [4, n_snr] float64, seconds).  `data` (harvested
        LLRs [num, N*z]) replaces fresh noise when given; `snr_sigmas` then
        typically has a single dummy entry.  Fresh noise is drawn from
        `generator`, one batch per (batch, SNR) pair in row-major order."""
        t0 = time.perf_counter()
        snr_sigmas = np.atleast_1d(np.asarray(snr_sigmas, np.float32))
        n_snr = snr_sigmas.size
        batch = self.batch
        batch_num = sample_num // batch
        if batch_num == 0:
            raise ValueError(f"sample_num {sample_num} < batch {batch}")
        if data is None and generator is None:
            raise ValueError("fresh-noise evaluation needs a generator")
        dev = self.decoder.device
        nbits = self.decoder.target * self.decoder.z
        shard = batch_constraint(self.mesh)
        labels = shard(torch.zeros((nbits, batch), dtype=torch.float32, device=dev))
        rows_dev = (None if data is None else torch.as_tensor(
            np.asarray(data[:batch_num * batch], np.float32), device=dev))
        writer = self.mesh is None or self.mesh.rank == 0
        ints, losses = [], []
        for bi in range(batch_num):
            for si in range(n_snr):
                if rows_dev is None:
                    sig = torch.full((batch,), float(snr_sigmas[si]),
                                     dtype=torch.float32, device=dev)
                    llr = self.channel.sample(generator, sig)
                else:
                    llr = rows_dev[bi * batch:(bi + 1) * batch].T
                c, loss, uncor = self._metrics(params, shard(llr).contiguous(),
                                               labels, etha)
                ints.append(c)
                losses.append(loss)
                if collect_uncor_path is not None:
                    uncor = gather_lanes(self.mesh, uncor.to(torch.uint8)).bool()
                    hits = llr[:, uncor]
                    if hits.shape[1] and writer:
                        append_uncor_file(collect_uncor_path,
                                          hits.T.cpu().numpy())
        # per-batch [batch_num, n_snr, 3] -> float64 totals on the host;
        # under a mesh, the ranks' counters summed and their losses averaged
        ints = all_sum(self.mesh, torch.stack(ints)).cpu().numpy().astype(np.float64)
        ints = ints.reshape(batch_num, n_snr, 3).sum(axis=0)
        losses = all_sum(self.mesh, torch.stack(losses)).cpu().numpy().astype(np.float64)
        losses = losses.reshape(batch_num, n_snr).sum(axis=0)
        if self.mesh is not None:
            losses /= self.mesh.world
        results = np.zeros((4, n_snr), np.float64)
        results[0] = ints[:, 0] / (batch * nbits) / batch_num
        results[1] = ints[:, 1] / batch / batch_num
        results[2] = ints[:, 2] / batch / batch_num
        results[3] = losses / batch_num
        return results, time.perf_counter() - t0

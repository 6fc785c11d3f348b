"""Monte-Carlo BER/FER simulation (port of `ldpc_error_floor_tpu/sim/fer.py`,
genie stop with the all-zero codeword).

Metric definitions, as in the JAX package:

* **BER_last** — bit errors at the final iteration / decoded bits;
* **FER_last** — frames wrong at the final iteration / frames;
* **FER** (genie) — frames wrong at *every* iteration / frames.

Each step samples a batch on the device, decodes it and reduces it to three
counters there; the host reads three integers per batch.  One step is kept
in flight: step k+1 is enqueued before the host waits for step k's counters,
which are copied to pinned memory behind an event, so the card never idles
on the host's read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel
from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import Params


@dataclass
class SimCounters:
    frames: int = 0
    bit_errors_last: int = 0
    frame_errors_last: int = 0
    frame_errors_genie: int = 0

    def add(self, frames, be, fel, feg):
        self.frames += int(frames)
        self.bit_errors_last += int(be)
        self.frame_errors_last += int(fel)
        self.frame_errors_genie += int(feg)


@dataclass
class FERPoint:
    snr_db: float
    frames: int
    ber_last: float
    fer_last: float
    fer_genie: float
    seconds: float
    frames_per_sec: float


class _Pending:
    """One step's counters on their way to the host."""

    def __init__(self, counters: torch.Tensor):
        if counters.is_cuda:
            self._host = torch.empty(counters.shape, dtype=counters.dtype,
                                     pin_memory=True)
            self._host.copy_(counters, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = counters, None

    def get(self) -> List[int]:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


class FERSimulator:
    """Fused sample+decode+count Monte-Carlo engine for one (decoder, channel)."""

    def __init__(self, decoder: NMSDecoder, channel: AWGNChannel,
                 batch: int = 1024):
        if decoder.device.type != channel.device.type:
            raise ValueError(f"decoder on {decoder.device}, channel on "
                             f"{channel.device}")
        self.decoder = decoder
        self.channel = channel
        self.batch = batch
        self.device = decoder.device

    def _local_step(self, params: Params, generator: torch.Generator,
                    sigma: float) -> torch.Tensor:
        """Counters [bit errors last, frames wrong last, frames wrong at
        every iteration] of one batch, on the device."""
        sig = torch.full((self.batch,), sigma, dtype=torch.float32,
                         device=self.device)
        llr = self.channel.sample(generator, sig)
        res = self.decoder.apply(params, llr, collect="stats")
        return torch.stack([res.bit_errors[-1].sum(dtype=torch.int64),
                            res.err_flags[-1].sum(dtype=torch.int64),
                            res.uncor_mask.sum(dtype=torch.int64)])

    def run_point(self, params: Params, snr_db: float,
                  generator: torch.Generator,
                  max_frames: int = 10_000_000,
                  target_frame_errors: Optional[int] = 100,
                  min_frames: int = 0) -> FERPoint:
        """Simulate one SNR point until `target_frame_errors` genie frame
        errors (once at least `min_frames` frames are counted) or
        `max_frames` frames.  `max_frames` is a strict bound: the point runs
        whole batches and never counts more than `max_frames` frames (a
        `max_frames` below one batch is an error)."""
        sigma = float(np.float32(self.channel.code.snr_sigmas([snr_db])[0]))
        c = SimCounters()
        if max_frames < self.batch:
            raise ValueError(f"max_frames {max_frames} below one batch "
                             f"({self.batch}); raise max_frames or shrink "
                             "the batch")

        def target_met() -> bool:
            return (target_frame_errors is not None
                    and c.frames >= min_frames
                    and c.frame_errors_genie >= target_frame_errors)

        t0 = time.perf_counter()
        pending = None
        if not target_met():
            pending = _Pending(self._local_step(params, generator, sigma))
        while pending is not None:
            nxt = None
            if c.frames + 2 * self.batch <= max_frames:
                nxt = _Pending(self._local_step(params, generator, sigma))
            c.add(self.batch, *pending.get())
            pending = nxt
            if target_met():
                break
        dt = time.perf_counter() - t0
        nbits = self.decoder.target * self.decoder.z
        return FERPoint(
            snr_db=float(snr_db), frames=c.frames,
            ber_last=c.bit_errors_last / (c.frames * nbits),
            fer_last=c.frame_errors_last / c.frames,
            fer_genie=c.frame_errors_genie / c.frames,
            seconds=dt,
            frames_per_sec=c.frames / dt if dt > 0 else 0.0)

    def run_curve(self, params: Params, snrs_db: Sequence[float],
                  generator: torch.Generator, **kw) -> List[FERPoint]:
        """One `run_point` per SNR, drawing from the same generator."""
        return [self.run_point(params, s, generator, **kw) for s in snrs_db]

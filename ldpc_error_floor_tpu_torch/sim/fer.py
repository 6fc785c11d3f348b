"""Monte-Carlo BER/FER simulation (port of `ldpc_error_floor_tpu/sim/fer.py`).

Metric definitions, as in the JAX package:

* **BER_last** — bit errors at the final iteration / decoded bits;
* **FER_last** — frames wrong at the final iteration / frames;
* **FER** (genie) — frames wrong at *every* iteration / frames.

``stop='syndrome'`` runs the deployable stop instead: each frame stops at
its first iteration whose hard decisions satisfy H*x == 0; FER_last and
BER_last then count errors at each frame's stop, and the point also reports
the undetected-error rate (wrong frames whose syndrome held) and the mean
iterations.  ``codewords='random'`` transmits fresh encoded random messages
and decodes the sign-folded LLRs against the zero word.

Each step samples a batch on the device, decodes it and reduces it to a
few counters there; the host reads those integers per batch.  One step is
kept in flight: step k+1 is enqueued before the host waits for step k's
counters, which are copied to pinned memory behind an event, so the card
never idles on the host's read.  `run_point(ckpt_path=...)` keeps an atomic
JSON checkpoint of the counters and the generator state, so a killed point
resumes where it was counted.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel
from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import Params

_COUNTERS = ("frames", "bit_errors_last", "frame_errors_last",
             "frame_errors_genie", "frame_errors_undetected", "iters_sum")


@dataclass
class SimCounters:
    frames: int = 0
    bit_errors_last: int = 0
    frame_errors_last: int = 0
    frame_errors_genie: int = 0
    # syndrome ("deploy") stop mode extras
    frame_errors_undetected: int = 0
    iters_sum: int = 0

    def add(self, frames, be, fel, feg):
        self.frames += int(frames)
        self.bit_errors_last += int(be)
        self.frame_errors_last += int(fel)
        self.frame_errors_genie += int(feg)

    def add_deploy(self, frames, be, fe, undet, iters):
        """Syndrome-stop counters: `fe`/`be` are frame/bit errors at each
        frame's own stop iteration; `undet` are wrong frames whose syndrome
        was satisfied (miscorrections); `iters` is total iterations run."""
        self.frames += int(frames)
        self.bit_errors_last += int(be)
        self.frame_errors_last += int(fe)
        self.frame_errors_undetected += int(undet)
        self.iters_sum += int(iters)


def _save_ckpt(path: str, obj: dict) -> None:
    """Atomic JSON write (tmp + rename) so a crash never corrupts it."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _load_ckpt(path: Optional[str], snr_db: float) -> Optional[dict]:
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        obj = json.load(f)
    if obj.get("snr_db") != float(snr_db):
        return None
    return obj


def generator_state(generator: torch.Generator) -> List[int]:
    """A generator's state as a JSON-able list (read on the host: for a
    CUDA generator it is seed and offset, no device sync)."""
    return generator.get_state().tolist()


def set_generator_state(generator: torch.Generator, state: List[int]) -> None:
    generator.set_state(torch.tensor(state, dtype=torch.uint8))


@dataclass
class FERPoint:
    snr_db: float
    frames: int
    ber_last: float
    fer_last: float
    fer_genie: float
    seconds: float
    frames_per_sec: float
    # populated only by stop='syndrome' runs
    fer_undetected: Optional[float] = None
    avg_iters: Optional[float] = None


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
                 batch: int = 1024, stop: str = "genie",
                 codewords: str = "zero"):
        if decoder.device.type != channel.device.type:
            raise ValueError(f"decoder on {decoder.device}, channel on "
                             f"{channel.device}")
        if stop not in ("genie", "syndrome"):
            raise ValueError(f"bad stop mode {stop!r}")
        if codewords not in ("zero", "random"):
            raise ValueError(f"bad codewords mode {codewords!r}")
        self.decoder = decoder
        self.channel = channel
        self.batch = batch
        self.device = decoder.device
        self.stop = stop
        self.codewords = codewords
        if codewords == "random":
            from ldpc_error_floor_tpu_torch.codes.encoder import Encoder
            self._encoder = Encoder(decoder.graph, device=self.device)

    def _sample(self, generator: torch.Generator, sigma: float) -> torch.Tensor:
        sig = torch.full((self.batch,), sigma, dtype=torch.float32,
                         device=self.device)
        if self.codewords == "zero":
            return self.channel.sample(generator, sig)
        # random codewords, decoded as sign-folded LLRs against the zero
        # word (exact for continuous channels; under QMS zero-LLR ties
        # follow the zero-word semantics, as in the JAX package)
        bits = self._encoder.random_codewords(generator, self.batch)
        llr = self.channel.sample_codewords(generator, sig, bits)
        return llr * (1.0 - 2.0 * bits)

    def _local_step(self, params: Params, generator: torch.Generator,
                    sigma: float) -> torch.Tensor:
        """One batch's counters on the device: [bit errors, frames wrong
        (at the last iteration / at each frame's stop), frames wrong at
        every iteration] (genie), or [bit errors, frames wrong, undetected,
        iterations] (syndrome)."""
        llr = self._sample(generator, sigma)
        if self.stop == "syndrome":
            res = self.decoder.apply(params, llr, collect="deploy")
            return torch.stack([res.bit_errors.sum(dtype=torch.int64),
                                res.wrong.sum(dtype=torch.int64),
                                res.undetected.sum(dtype=torch.int64),
                                res.iters.sum(dtype=torch.int64)])
        res = self.decoder.apply(params, llr, collect="stats")
        return torch.stack([res.bit_errors[-1].sum(dtype=torch.int64),
                            res.err_flags[-1].sum(dtype=torch.int64),
                            res.uncor_mask.sum(dtype=torch.int64)])

    @staticmethod
    def _ckpt_obj(snr_db: float, c: SimCounters, state: List[int],
                  done: bool = False) -> dict:
        return {"snr_db": float(snr_db), **{f: getattr(c, f) for f in _COUNTERS},
                "generator_state": state, "done": done}

    def run_point(self, params: Params, snr_db: float,
                  generator: torch.Generator,
                  max_frames: int = 10_000_000,
                  target_frame_errors: Optional[int] = 100,
                  min_frames: int = 0,
                  ckpt_path: Optional[str] = None,
                  ckpt_every_s: float = 60.0) -> FERPoint:
        """Simulate one SNR point until `target_frame_errors` frame errors
        (genie errors, or errors at the stop under ``stop='syndrome'``)
        once at least `min_frames` frames are counted, or `max_frames`
        frames.  `max_frames` is a strict bound: the point runs whole
        batches and never counts more than `max_frames` frames (a
        `max_frames` below one batch is an error).

        `ckpt_path`: JSON checkpoint of the counters and the generator state
        that regenerates every batch not yet counted, written atomically at
        most every `ckpt_every_s` seconds.  Re-running with the same path
        resumes exactly: the batch in flight at a crash is simulated again,
        so every frame counts once.  A finished point's record is marked
        ``"done"``; re-running the same command then returns its counters
        without new work, since the stop rules are checked against the
        resumed counters before anything is launched."""
        sigma = float(np.float32(self.channel.code.snr_sigmas([snr_db])[0]))
        c = SimCounters()
        resumed = _load_ckpt(ckpt_path, snr_db)
        if resumed is not None:
            for f in _COUNTERS:
                setattr(c, f, int(resumed.get(f, 0)))
            set_generator_state(generator, resumed["generator_state"])
        frames0 = c.frames
        if max_frames < self.batch and c.frames == 0:
            raise ValueError(f"max_frames {max_frames} below one batch "
                             f"({self.batch}); raise max_frames or shrink "
                             "the batch")
        syndrome = self.stop == "syndrome"

        def target_met() -> bool:
            errors = c.frame_errors_last if syndrome else c.frame_errors_genie
            return (target_frame_errors is not None
                    and c.frames >= min_frames
                    and errors >= target_frame_errors)

        t0 = time.perf_counter()
        t_ckpt = t0
        pending = None
        # the generator state that regenerates every batch not yet counted
        state_unacc = generator_state(generator) if ckpt_path else None
        if c.frames + self.batch <= max_frames and not target_met():
            pending = _Pending(self._local_step(params, generator, sigma))
        while pending is not None:
            nxt = None
            state_next = generator_state(generator) if ckpt_path else None
            if c.frames + 2 * self.batch <= max_frames:
                nxt = _Pending(self._local_step(params, generator, sigma))
            if syndrome:
                c.add_deploy(self.batch, *pending.get())
            else:
                c.add(self.batch, *pending.get())
            pending = nxt
            state_unacc = state_next
            now = time.perf_counter()
            if ckpt_path and now - t_ckpt >= ckpt_every_s:
                t_ckpt = now
                _save_ckpt(ckpt_path, self._ckpt_obj(snr_db, c, state_unacc))
            if target_met():
                break
        if ckpt_path:
            # final record: a re-run of the same command reports the point
            # done instead of silently extending it
            _save_ckpt(ckpt_path, self._ckpt_obj(snr_db, c, state_unacc,
                                                 done=True))
        dt = time.perf_counter() - t0
        nbits = self.decoder.target * self.decoder.z
        return FERPoint(
            snr_db=float(snr_db), frames=c.frames,
            ber_last=c.bit_errors_last / (c.frames * nbits),
            fer_last=c.frame_errors_last / c.frames,
            fer_genie=(float("nan") if syndrome
                       else c.frame_errors_genie / c.frames),
            seconds=dt,
            frames_per_sec=(c.frames - frames0) / dt if dt > 0 else 0.0,
            fer_undetected=(c.frame_errors_undetected / c.frames
                            if syndrome else None),
            avg_iters=c.iters_sum / c.frames if syndrome else None)

    def run_curve(self, params: Params, snrs_db: Sequence[float],
                  generator: torch.Generator,
                  ckpt_prefix: Optional[str] = None, **kw) -> List[FERPoint]:
        """One `run_point` per SNR, each on a generator of its own seeded
        from `generator` (one draw per point, whether or not the point
        resumes), so a resumed curve repeats an uninterrupted one.
        `ckpt_prefix`: per-SNR resume files ``{prefix}_snr{s}.json``."""
        out = []
        for s in snrs_db:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            sub = torch.Generator(device=generator.device).manual_seed(seed)
            ckpt = f"{ckpt_prefix}_snr{s}.json" if ckpt_prefix else None
            out.append(self.run_point(params, s, sub, ckpt_path=ckpt, **kw))
        return out

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
few counters there.  `inner_steps` = K steps make one chunk, whose counters
are summed on the device; the host reads them once per chunk (JAX runs the
K steps under one `lax.scan` in one jitted dispatch).  Under the genie stop
the chunk's K batches are sampled in turn into one read buffer [K, N*z, B]
and decoded by one call that returns only the chunk's counters
(`NMSDecoder.read_totals`: on the card, under QMS with the early stop, one
launch of the early-stop kernel over the K*B words, which writes no
per-word rows); under the syndrome stop each batch is decoded alone.  On
the card a chunk is one replay of a CUDA graph that holds its K steps,
captured once for each parameter set, generator, SNR and configuration
(`_GraphedChunk`); on the CPU the same steps run eagerly.  One chunk is
kept in flight: chunk k+1 is enqueued before the host waits for chunk k's
counters, which are copied to pinned memory behind an event, so the card
never idles on the host's read.  `run_point(ckpt_path=...)` keeps an atomic JSON checkpoint of the
counters and the generator state, so a killed point resumes where it was
counted.

With a mesh (`parallel.mesh`), `batch` is the global batch: each rank
samples and decodes its share of the lanes from its own generator
(`rank_generator`), and one `all_reduce` sums a chunk's counters after the
replay, on the same stream, before they are copied to the host: one
collective per host read and no host synchronisation.  Every stop rule
reads the summed counters, so every rank stops on the same read.

Under a profiler `run_point` records host spans (`utils.profiling.annotate`):
``ldpc.fer.point``, the whole call; within it ``ldpc.fer.start``, from
entry until the first read is enqueued (the resume, the rank's generator,
sigma and the first issue); ``ldpc.fer.issue`` (a read's replay, its mesh
sum and the copy behind its event) and within an issue that needs a new
graph ``ldpc.fer.capture`` (`_capture`); ``ldpc.fer.wait`` (the host
waiting for a read's counters) and ``ldpc.fer.ckpt`` (a checkpoint write).
Nothing inside the captured steps opens a span.
"""

from __future__ import annotations

import collections
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel
from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import KINDS, Params, stack_weights
from ldpc_error_floor_tpu_torch.parallel.mesh import (DataMesh, all_max, all_sum,
                                                      rank_generator)
from ldpc_error_floor_tpu_torch.utils.profiling import annotate

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


def part_path(path: Optional[str], mesh: Optional[DataMesh]) -> Optional[str]:
    """This rank's file for `path`: `path` itself in a world of one,
    ``{path}.part{rank}`` in a larger one."""
    if path is None or mesh is None or mesh.world == 1:
        return path
    return f"{path}.part{mesh.rank}"


def resume_ckpt(ckpt_path: Optional[str], snr_db: float,
                mesh: Optional[DataMesh]):
    """(this rank's checkpoint file, what it holds or None).  Each file
    records the world's size; under a mesh every rank raises together (the
    checks are reduced over the ranks, so no rank is left waiting) when a
    rank's file cannot be read, when a file was written by a world of
    another size, or when the ranks' files count different frames."""
    path = part_path(ckpt_path, mesh)
    if path is None:
        return path, None
    world = 1 if mesh is None else mesh.world
    other = path + ".part0" if world == 1 else ckpt_path
    error = None
    try:
        resumed = _load_ckpt(path, snr_db)
        foreign = int(resumed.get("world", 1) != world if resumed is not None
                      else os.path.exists(other))
        frames = 0 if resumed is None else int(resumed["frames"])
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
        resumed, foreign, frames, error = None, 0, 0, e
    failed, most, fewest = int(error is not None), frames, frames
    if mesh is not None:
        failed, foreign, most, fewest = all_max(
            mesh, [failed, foreign, frames, -frames])
        fewest = -fewest
    if failed:
        raise ValueError(f"{ckpt_path}: a rank's checkpoint cannot be read"
                         + (f" ({path}: {error!r})" if error else "")) from error
    if foreign:
        raise ValueError(f"{ckpt_path}: checkpoint written by a world of "
                         f"another size than {world}")
    if most != fewest:
        raise ValueError(f"{ckpt_path}: the ranks' checkpoints count "
                         f"{fewest} to {most} frames")
    return path, resumed


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
    """One chunk's counters on their way to the host, with the flag that
    says whether its read checkpoints: under a mesh the flag travels as the
    counters' last entry, summed over the ranks."""

    def __init__(self, counters: torch.Tensor, ckpt_due: bool,
                 reduced: bool = False):
        if counters.is_cuda:
            self._host = torch.empty(counters.shape, dtype=counters.dtype,
                                     pin_memory=True)
            self._host.copy_(counters, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = counters, None
        self._due, self._reduced = ckpt_due, reduced

    def get(self):
        """(the counters, whether to checkpoint after them)."""
        with annotate("ldpc.fer.wait"):
            if self._event is not None:
                self._event.synchronize()
            vals = self._host.tolist()
        if self._reduced:
            return vals[:-1], vals[-1] > 0
        return vals, self._due


class _GraphedChunk:
    """One chunk of K steps captured as a CUDA graph, with what it was
    captured for: the parameter tensors and the generator (by identity,
    kept alive here so an identity is never reused), sigma and the
    simulator's configuration.  Its `launches` are the kernel launches the
    capture recorded, one count for each of `FERSimulator._counted`, which
    every replay makes once."""

    def __init__(self, key: tuple, params: Params, generator: torch.Generator,
                 graph: "torch.cuda.CUDAGraph", out: torch.Tensor,
                 launches: List[collections.Counter]):
        self.key, self.params, self.generator = key, params, generator
        self.graph, self.out, self.launches = graph, out, launches

    def fits(self, key: tuple, params: Params, generator: torch.Generator) -> bool:
        return (self.key == key and self.generator is generator
                and all(self.params.get(k) is params.get(k) for k in KINDS))


class FERSimulator:
    """Fused sample+decode+count Monte-Carlo engine for one (decoder, channel).

    `inner_steps` = K batches make one chunk, counted on the device and read
    by the host once (`run_point`).  As in the JAX package, K is clamped to
    ``max(1, (2**31 - 1) // (batch * nbits))`` (nbits: the bits counted per
    word), JAX's int32 headroom for the bit-error counter.  The port counts
    in int64 and needs no such bound, but keeps the clamp: it sets how many
    frames one chunk holds, and that decides where `max_frames` stops a
    point, so both packages stop a point at the same frame count.

    `mesh`: `batch` is global and must divide by the world's size; each
    rank decodes ``batch // world`` lanes and the counters are summed."""

    def __init__(self, decoder: NMSDecoder, channel: AWGNChannel,
                 batch: int = 1024, stop: str = "genie",
                 codewords: str = "zero", inner_steps: int = 1,
                 mesh: Optional[DataMesh] = None):
        if decoder.device.type != channel.device.type:
            raise ValueError(f"decoder on {decoder.device}, channel on "
                             f"{channel.device}")
        if stop not in ("genie", "syndrome"):
            raise ValueError(f"bad stop mode {stop!r}")
        if codewords not in ("zero", "random"):
            raise ValueError(f"bad codewords mode {codewords!r}")
        if mesh is not None and batch % mesh.world:
            raise ValueError(f"batch {batch} not divisible by the mesh's "
                             f"{mesh.world} ranks")
        self.decoder = decoder
        self.channel = channel
        self.batch = batch
        self.mesh = mesh
        self.local_batch = batch if mesh is None else batch // mesh.world
        self.device = decoder.device
        self.stop = stop
        self.codewords = codewords
        if codewords == "random":
            from ldpc_error_floor_tpu_torch.codes.encoder import Encoder
            self._encoder = Encoder(decoder.graph, device=self.device)
        if inner_steps < 1:
            raise ValueError("inner_steps must be >= 1")
        nbits = decoder.target * decoder.z
        self.inner_steps = min(inner_steps,
                               max(1, (2 ** 31 - 1) // max(batch * nbits, 1)))
        self._graphed: Optional[_GraphedChunk] = None
        self._llr_read: Optional[torch.Tensor] = None

    def _sample(self, generator: torch.Generator, sigma: float,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One batch's LLRs [N*z, local batch], into `out` where given."""
        sig = torch.full((self.local_batch,), sigma, dtype=torch.float32,
                         device=self.device)
        if self.codewords == "zero":
            return self.channel.sample(generator, sig, out=out)
        # random codewords, decoded as sign-folded LLRs against the zero
        # word (exact for continuous channels; under QMS zero-LLR ties
        # follow the zero-word semantics, as in the JAX package)
        bits = self._encoder.random_codewords(generator, self.local_batch)
        return self.channel.sample_codewords(generator, sig, bits, fold=True, out=out)

    def _read_buffer(self) -> torch.Tensor:
        """The LLRs of one chunk under the genie stop, [K, N*z, local
        batch] float32: made once for its shape and kept across points, so
        that no capture allocates it in its graph's pool."""
        shape = (self.inner_steps, self.decoder.N * self.decoder.z, self.local_batch)
        if self._llr_read is None or tuple(self._llr_read.shape) != shape:
            self._llr_read = None
            self._llr_read = torch.empty(shape, dtype=torch.float32, device=self.device)
        return self._llr_read

    def _local_step(self, params: Params, generator: torch.Generator,
                    sigma: float) -> torch.Tensor:
        """This rank's counters of one chunk of K batches, on the device:
        [bit errors, frames wrong at the last iteration, frames wrong at
        every iteration] (genie), or [bit errors, frames wrong at each
        frame's stop, undetected, iterations] (syndrome).  Under the genie
        stop the K batches are sampled in turn into the read buffer, the
        same draws from `generator` as K steps of one batch, and decoded by
        one `NMSDecoder.read_totals` call; under the syndrome stop each
        batch is decoded alone and the counters summed."""
        if self.stop == "genie":
            llr = self._read_buffer()
            for k in range(self.inner_steps):
                self._sample(generator, sigma, out=llr[k])
            return self.decoder.read_totals(params, llr)
        acc = None
        for _ in range(self.inner_steps):
            res = self.decoder.apply(params, self._sample(generator, sigma),
                                     collect="deploy")
            counts = torch.stack([res.bit_errors.sum(dtype=torch.int64),
                                  res.wrong.sum(dtype=torch.int64),
                                  res.undetected.sum(dtype=torch.int64),
                                  res.iters.sum(dtype=torch.int64)])
            acc = counts if acc is None else acc + counts
        return acc

    def _chunk(self, params: Params, generator: torch.Generator,
               sigma: float) -> torch.Tensor:
        """One chunk's counters on the device: on the card one replay of
        the CUDA graph of `_local_step`, on the CPU `_local_step` itself."""
        with torch.no_grad():
            if self.device.type == "cpu":
                return self._local_step(params, generator, sigma)
            key = (float(sigma), self.batch, self.inner_steps, self.stop,
                   self.codewords)
            g = self._graphed
            if g is None or not g.fits(key, params, generator):
                self._graphed = None  # free the stale graph's memory first
                with annotate("ldpc.fer.capture"):
                    g = self._graphed = self._capture(key, params, generator, sigma)
            g.graph.replay()
            for owner, n in zip(self._counted(), g.launches):
                owner.launches.update(n)
            return g.out

    def _counted(self) -> tuple:
        """The wrappers whose launches a captured chunk counts (each has
        `launches` and `captured`): the decode kernel's and the channel's."""
        return self.decoder.kernel, self.channel

    def _read(self, params: Params, generator: torch.Generator, sigma: float,
              ckpt_due: bool) -> _Pending:
        """One chunk, enqueued, its counters on their way to the host.
        Under a mesh they are summed over the ranks, with `ckpt_due` (this
        rank's checkpoint timer ran out) appended, so that every rank
        checkpoints on the same read.  The sum runs outside the captured
        graph, after the replay on the same stream; the next replay, which
        overwrites the graph's output, is enqueued after the copy."""
        with annotate("ldpc.fer.issue"):
            counters = self._chunk(params, generator, sigma)
            if self.mesh is None:
                return _Pending(counters, ckpt_due)
            flagged = torch.empty(counters.numel() + 1, dtype=torch.int64,
                                  device=counters.device)
            flagged[:-1].copy_(counters)
            flagged[-1:].fill_(int(ckpt_due))
            return _Pending(all_sum(self.mesh, flagged), ckpt_due, reduced=True)

    def _capture(self, key: tuple, params: Params, generator: torch.Generator,
                 sigma: float) -> _GraphedChunk:
        """Capture `_local_step` as a CUDA graph that draws from `generator`.

        Nothing runs while a graph is captured: a replay draws from the
        generator's state at the replay, exactly the numbers K eager steps
        would, and leaves the generator where they would.  Whatever a step
        first copies from the host (the weights' row index, the kernel's
        graph table, the encoder's first product) is made before the
        capture, which allows no host copy; the capture itself must not
        synchronise, and raises if a step does.  The read buffer is made
        before it too, outside the graph's pool."""
        kernel = self.decoder.kernel
        stack_weights(self.decoder.spec, params)
        kernel.graph_table(self.device)
        if self.stop == "genie":
            self._read_buffer()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.codewords == "random":
            with torch.cuda.stream(stream):
                self._encoder.encode(torch.zeros((self._encoder.k, 1),
                                                 device=self.device))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        for owner in self._counted():
            owner.captured.clear()
        # capture_begin/capture_end, not the `torch.cuda.graph` context: it
        # also synchronises, collects garbage and empties the allocator's
        # cache, which a point's first host read would wait for
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = self._local_step(params, generator, sigma)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        launches = []
        for owner in self._counted():
            launches.append(collections.Counter(owner.captured))
            owner.captured.clear()
        return _GraphedChunk(key, dict(params), generator, graph, out, launches)

    def _ckpt_obj(self, snr_db: float, c: SimCounters, state: List[int],
                  done: bool = False) -> dict:
        return {"snr_db": float(snr_db), **{f: getattr(c, f) for f in _COUNTERS},
                "generator_state": state, "done": done,
                "world": 1 if self.mesh is None else self.mesh.world}

    def run_point(self, params: Params, snr_db: float,
                  generator: torch.Generator,
                  max_frames: int = 10_000_000,
                  target_frame_errors: Optional[int] = 100,
                  min_frames: int = 0,
                  progress: Optional[Callable[[SimCounters], None]] = None,
                  ckpt_path: Optional[str] = None,
                  ckpt_every_s: float = 60.0) -> FERPoint:
        """Simulate one SNR point until `target_frame_errors` frame errors
        (genie errors, or errors at the stop under ``stop='syndrome'``)
        once at least `min_frames` frames are counted, or `max_frames`
        frames.  `max_frames` is a strict bound: the point runs whole
        chunks of ``batch * inner_steps`` frames and never counts more than
        `max_frames` frames (a `max_frames` below one chunk is an error).
        `progress(counters)` is called after every 50th host read.

        `ckpt_path`: JSON checkpoint of the counters and the generator state
        that regenerates every chunk not yet counted, written atomically at
        most every `ckpt_every_s` seconds.  Re-running with the same path
        resumes exactly: the chunk in flight at a crash is simulated again,
        so every frame counts once.  A finished point's record is marked
        ``"done"``; re-running the same command then returns its counters
        without new work, since the stop rules are checked against the
        resumed counters before anything is launched.

        Under a mesh every rank passes the same `generator` state and draws
        from its `rank_generator`; in a world of W > 1 each rank keeps its
        checkpoint in ``{ckpt_path}.part{rank}`` (the summed counters and
        its generator's state), and a resume under another world size
        raises (`resume_ckpt`)."""
        with annotate("ldpc.fer.point"):
            with annotate("ldpc.fer.start"):
                sigma = float(np.float32(self.channel.code.snr_sigmas([snr_db])[0]))
                c = SimCounters()
                ckpt_path, resumed = resume_ckpt(ckpt_path, snr_db, self.mesh)
                generator = rank_generator(generator, self.mesh)
                if resumed is not None:
                    for f in _COUNTERS:
                        setattr(c, f, int(resumed.get(f, 0)))
                    set_generator_state(generator, resumed["generator_state"])
                frames0 = c.frames
                frames_per_step = self.batch * self.inner_steps
                if max_frames < frames_per_step and c.frames == 0:
                    raise ValueError(
                        f"max_frames {max_frames} below one simulation chunk "
                        f"(batch {self.batch} * inner_steps {self.inner_steps}); "
                        "raise max_frames or shrink the batch")
                syndrome = self.stop == "syndrome"

                def target_met() -> bool:
                    errors = c.frame_errors_last if syndrome else c.frame_errors_genie
                    return (target_frame_errors is not None
                            and c.frames >= min_frames
                            and errors >= target_frame_errors)

                t0 = time.perf_counter()
                t_ckpt = t0

                def read() -> _Pending:
                    # the timer restarts when a due read is queued, so the read
                    # queued behind it (before its checkpoint) is not due as well
                    nonlocal t_ckpt
                    now = time.perf_counter()
                    due = bool(ckpt_path) and now - t_ckpt >= ckpt_every_s
                    if due:
                        t_ckpt = now
                    return self._read(params, generator, sigma, due)

                pending = None
                reads = 0
                # the generator state that regenerates every chunk not yet counted
                state_unacc = generator_state(generator) if ckpt_path else None
                if c.frames + frames_per_step <= max_frames and not target_met():
                    pending = read()
            while pending is not None:
                nxt = None
                state_next = generator_state(generator) if ckpt_path else None
                if c.frames + 2 * frames_per_step <= max_frames:
                    nxt = read()
                counts, ckpt_due = pending.get()
                if syndrome:
                    c.add_deploy(frames_per_step, *counts)
                else:
                    c.add(frames_per_step, *counts)
                pending = nxt
                state_unacc = state_next
                reads += 1
                if progress is not None and reads % 50 == 0:
                    progress(c)
                if ckpt_due:
                    with annotate("ldpc.fer.ckpt"):
                        _save_ckpt(ckpt_path, self._ckpt_obj(snr_db, c, state_unacc))
                if target_met():
                    break
            if ckpt_path:
                # final record: a re-run of the same command reports the point
                # done instead of silently extending it
                with annotate("ldpc.fer.ckpt"):
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
        `ckpt_prefix`: per-SNR resume files ``{prefix}_snr{s}.json``; `kw`
        (`max_frames`, `progress`, ...) goes to each `run_point`."""
        out = []
        for s in snrs_db:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            sub = torch.Generator(device=generator.device).manual_seed(seed)
            ckpt = f"{ckpt_prefix}_snr{s}.json" if ckpt_prefix else None
            out.append(self.run_point(params, s, sub, ckpt_path=ckpt, **kw))
        return out

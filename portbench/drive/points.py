"""Traffic of kind "points": back-to-back Monte-Carlo FER points through
the port's `FERSimulator.run_point`, as an error-floor run makes them.

Every point has the same SNR and size (`frames_per_point`); each takes a
CUDA generator of its own, seeded from the run's seed and the point's index,
as `FERSimulator.run_curve` gives each point one.  With `ranks` > 1 the
points run across that many ranks of an NCCL world (`portbench/mesh.py`).

The check: once the window has closed, one point drawn from the seed is
decoded again by the plain reference (`portbench/reference/decode.py`) on
the noise drawn from the same generator, and its genie count must equal
the program's.  The count of frames wrong at every iteration is the one
counter that no design choice of the kernel may change: the errors at the
last iteration depend on how many words the early-stop kernel groups.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.reference.decode import RefCode, RefDecoder, load_weight_rows, rank_seed

GENIE_GAP_LIMIT = 0  # the genie counts compared exactly


def point_seed(seed: int, index: int) -> int:
    """The generator seed of point `index` of a run with `seed` (index -1:
    the warm-up point's)."""
    words = np.random.SeedSequence([seed % 2 ** 64, index % 2 ** 32]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


@dataclass
class Program:
    """The port's objects for one cell: simulator, parameters, the wrappers
    whose launches it counts."""
    sim: object
    params: dict
    snr: float
    frames: int
    device: torch.device
    counters: List[object] = field(default_factory=list)


def setup(cfg: dict, traffic: dict, device, phase, seed: int, mesh=None) -> Program:
    """Build the program for the cell and warm it up: one point of one host
    read on the window's shapes (its capture and every kernel)."""
    with phase("imports"):
        from ldpc_error_floor_tpu_torch.channel import AWGNChannel
        from ldpc_error_floor_tpu_torch.codes import Code, TannerGraph
        from ldpc_error_floor_tpu_torch.io import read_weight_json
        from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,
                                                       WeightSpec, params_from_blocks)
        from ldpc_error_floor_tpu_torch.sim import FERSimulator
    dev = torch.device(device)
    if dev.type == "cuda":
        with phase("library"):
            from ldpc_error_floor_tpu_torch.ops import awgn_llr, fused_decoder
            fused_decoder.load_library()
            awgn_llr.load_library()
    with phase("params"):
        c, d = cfg["code"], cfg["decoder"]
        code = Code.load(str(harness.path(c["file"])), z=c["z"], punct=tuple(c["punct"]),
                         short=tuple(c["short"]), name=c["name"])
        graph = TannerGraph(code)
        spec = WeightSpec(sharing=tuple(d["sharing"]), n_iters=d["n_iters"])
        dcfg = DecoderConfig(decoding_type=d["decoding_type"], q_bit=d["q_bit"],
                             clip_llr=d["clip_llr"], target_node=d["target_node"],
                             early_stop=traffic["stop"] == "genie_early")
        dec = NMSDecoder(code, dcfg, spec, graph=graph, device=dev)
        ch = AWGNChannel(code, decoding_type=d["decoding_type"], q_bit=d["q_bit"],
                         clip_llr=d["clip_llr"], device=dev)
        _, blocks = read_weight_json(str(harness.path(cfg["weights"])))
        params = params_from_blocks(spec, blocks, graph, device=dev)
        batch = traffic["batch_per_rank"] * (1 if mesh is None else mesh.world)
        sim = FERSimulator(dec, ch, batch=batch, inner_steps=traffic["inner_steps"],
                           mesh=mesh)
        prog = Program(sim, params, traffic["snr_db"], traffic["frames_per_point"], dev,
                       [dec.kernel, ch])
    with phase("warm_up"):
        gen = torch.Generator(device=dev).manual_seed(point_seed(seed, -1))
        sim.run_point(params, prog.snr, gen, max_frames=batch * sim.inner_steps,
                      target_frame_errors=None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return prog


def window(prog: Program, seed: int, seconds: float, span, stop_together) -> dict:
    """Points until `seconds` have passed, each whole: the points' seeds and
    counters, and the launches per batch of each counted wrapper."""
    before = [dict(w.launches) for w in prog.counters]
    points = []
    t0 = time.perf_counter()
    while True:
        k = len(points)
        gen = torch.Generator(device=prog.device).manual_seed(point_seed(seed, k))
        with span("point"):
            pt = prog.sim.run_point(prog.params, prog.snr, gen, max_frames=prog.frames,
                                    target_frame_errors=None)
        points.append({"seed": point_seed(seed, k), "frames": pt.frames,
                       "genie": int(round(pt.fer_genie * pt.frames))})
        if stop_together(time.perf_counter() - t0 >= seconds):
            break
    window_s = time.perf_counter() - t0
    frames = sum(p["frames"] for p in points)
    local = prog.sim.local_batch
    batches = frames // prog.sim.batch  # per rank
    launches = {}
    for w, b in zip(prog.counters, before):
        for name, n in w.launches.items():
            launches[name] = (n - b.get(name, 0)) / max(batches, 1)
    return {"points": points, "attempted": len(points), "frames": frames,
            "window_s": window_s, "batches_per_rank": batches, "local_batch": local,
            "reads": frames // (prog.sim.batch * prog.sim.inner_steps),
            "launches_per_batch": launches}


def release(prog: Program) -> None:
    prog.sim = prog.params = None
    prog.counters.clear()


def reference_decoder(cfg: dict, device) -> RefDecoder:
    c, d = cfg["code"], cfg["decoder"]
    code = RefCode.load(str(harness.path(c["file"])), c["z"], c["punct"], c["short"])
    _, rows = load_weight_rows(harness.path(cfg["weights"]))
    return RefDecoder(code, rows, d["n_iters"], d["q_bit"], d["clip_llr"], d["target_node"],
                      device)


def reference_point(ref: RefDecoder, snr_db: float, gen_seeds: List[int], batches: int,
                    local: int, device) -> Dict[str, int]:
    """The genie count and the words' own iterations of `batches` batches of
    `local` words drawn from the generator of each seed in `gen_seeds` (one
    for a point on one card; across ranks, each rank's)."""
    sigma = ref.code.sigma(snr_db)

    def llrs():
        for s in gen_seeds:
            gen = torch.Generator(device=device).manual_seed(s)
            for _ in range(batches):
                noise = torch.randn((ref.code.n_full, local), generator=gen,
                                    dtype=torch.float32, device=device)
                yield ref.llr(noise, sigma)

    genie, iters = ref.genie(llrs())
    return {"genie": genie, "word_iters": iters}


def check(cfg: dict, traffic: dict, result: dict, seed: int, device, world=None) -> dict:
    """Decode one point of the window, drawn from the seed, by the
    reference; the gap between the two genie counts against its limit.
    Across ranks each rank's reference decodes the noise of its own rank's
    generator, and the counts are summed."""
    pts = result["points"]
    k = int(np.random.default_rng([seed % 2 ** 64, 1]).integers(len(pts)))
    ref = reference_decoder(cfg, device)
    ranks, local = traffic.get("ranks", 1), traffic["batch_per_rank"]
    here = range(ranks) if world is None else [world.mesh.rank]
    seeds = ([pts[k]["seed"]] if ranks == 1 else
             [rank_seed(pts[k]["seed"], r, device) for r in here])
    got = reference_point(ref, traffic["snr_db"], seeds, pts[k]["frames"] // (local * ranks),
                          local, device)
    if world is not None:
        got["genie"], got["word_iters"] = world.sum([got["genie"], got["word_iters"]])
    gap = abs(pts[k]["genie"] - got["genie"])
    return {"correct": gap <= GENIE_GAP_LIMIT, "failed": int(gap > GENIE_GAP_LIMIT),
            "checks": {"genie_gap": {"value": gap, "limit": GENIE_GAP_LIMIT}},
            "detail": {"point": k, "program_genie": pts[k]["genie"],
                       "reference_genie": got["genie"], "frames": pts[k]["frames"]},
            "word_iters_per_word": got["word_iters"] / pts[k]["frames"]}

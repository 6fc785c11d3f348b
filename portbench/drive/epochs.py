"""Traffic of kind "epochs": back-to-back training epochs of the port's
`training/train.py::make_epoch_step`, as `pipelines/train.py` builds them
for a block: AWGN sampling on the card from one generator, the decode
through the training pair, the loss, Adam and the box clip.

Set-up builds one epoch function with its parameters and Adam state and
drives it from the seed through its first `checked_steps` epochs of one
step each; the window then calls the same function on.  The reference
(`portbench/reference/train.py`) follows those first steps from the same
starting weights on the noise of the same generator, and the run compares
each step's loss, the first gradient as Adam holds it after one step, and
the weights' change after the checked steps.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.reference.decode import RefCode
from portbench.reference.train import RefTrainer

# the numbers compared, each with its limit (PERF.md gives the readings)
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}
NEGLIGIBLE_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def train_seed(seed: int) -> int:
    words = np.random.SeedSequence([seed % 2 ** 64, 2 ** 32 - 2]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def sigmas(snrs, rate: float, batch: int) -> np.ndarray:
    """Per-word noise std cycling through the SNR list (float32)."""
    s = np.sqrt(1.0 / (2.0 * 10.0 ** (np.asarray(snrs, np.float64) / 10.0) * rate))
    return np.tile(s.astype(np.float32), batch // len(s) + 1)[:batch]


@dataclass
class Program:
    epoch: object
    params: dict
    optimizer: object
    generator: torch.Generator
    device: torch.device
    batch: int
    etha: float
    counters: List[object] = field(default_factory=list)
    first: Dict[str, object] = field(default_factory=dict)


def setup(cfg: dict, traffic: dict, device, phase, seed: int, mesh=None) -> Program:
    """Build the block's epoch function and run its first checked steps."""
    with phase("imports"):
        from ldpc_error_floor_tpu_torch.channel import AWGNChannel
        from ldpc_error_floor_tpu_torch.codes import Code, TannerGraph
        from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder, WeightSpec,
                                                       init_weights)
        from ldpc_error_floor_tpu_torch.training.train import make_epoch_step, make_optimizer
    dev = torch.device(device)
    if dev.type == "cuda":
        with phase("library"):
            from ldpc_error_floor_tpu_torch.ops import awgn_llr, fused_train
            fused_train.load_library()
            awgn_llr.load_library()
    with phase("params"):
        c, tr = cfg["code"], cfg["train"]
        code = Code.load(str(harness.path(c["file"])), z=c["z"], punct=tuple(c["punct"]),
                         short=tuple(c["short"]), name=c["name"])
        graph = TannerGraph(code)
        lo, hi = tr["block"]
        spec = WeightSpec(sharing=tuple(tr["sharing"]), n_iters=hi,
                          min_w=tr["min_weight"], max_w=tr["max_weight"])
        dcfg = DecoderConfig(decoding_type=tr["decoding_type"], q_bit=tr["q_bit"],
                             clip_llr=tr["clip_llr"], app_t0=hi - 1)
        dec = NMSDecoder(code, dcfg, spec, graph=graph, device=dev)
        ch = AWGNChannel(code, decoding_type=tr["decoding_type"], q_bit=tr["q_bit"],
                         clip_llr=tr["clip_llr"], device=dev)
        params = init_weights(spec, graph, tr["init_weight"], tr["init_vn_weight"], device=dev)
    with phase("optimizer"):
        optimizer = make_optimizer(params, tr["learn_rate"])
    with phase("epoch_fn"):
        B = traffic["batch"]
        labels = torch.zeros((code.N * code.z, B), dtype=torch.float32, device=dev)
        lanes = torch.as_tensor(sigmas(tr["snrs"], code.rate, B), device=dev)
        epoch = make_epoch_step(dec, spec, tr["loss_type"], lo, hi, 0,
                                n_steps=traffic["steps_per_epoch"], labels=labels,
                                channel=ch, sigmas=lanes, static_etha=tr["etha"])
        gen = torch.Generator(device=dev).manual_seed(train_seed(seed))
        prog = Program(epoch, params, optimizer, gen, dev, B, tr["etha"],
                       [dec.train_kernel, ch])
    with phase("first_steps"):
        start = {k: v.detach().clone() for k, v in params.items() if v is not None}
        losses = []
        for i in range(traffic["checked_steps"]):
            losses.append(epoch(params, optimizer, gen, tr["etha"]))
            if i == 0:
                # Adam's first moment after one step is 0.1 of the gradient
                # (none: the optimizer holds no gradient)
                grad = {k: optimizer.state[p].get("exp_avg", torch.zeros_like(p)).detach() / 0.1
                        for k, p in params.items() if p is not None}
        change = {k: (params[k].detach() - start[k]) for k in start}
        prog.first = {"loss": [float(x) for x in losses],
                      "grad": {k: float(g.norm()) for k, g in grad.items()},
                      "change": {k: float(v.norm()) for k, v in change.items()}}
    return prog


def window(prog: Program, seed: int, seconds: float, span, stop_together) -> dict:
    """Epochs until `seconds` have passed; the window closes when the card
    has finished them."""
    before = [dict(w.launches) for w in prog.counters]
    steps = 0
    t0 = time.perf_counter()
    while True:
        with span("epoch"):
            prog.epoch(prog.params, prog.optimizer, prog.generator, prog.etha)
        steps += 1
        if stop_together(time.perf_counter() - t0 >= seconds):
            break
    if prog.device.type == "cuda":
        torch.cuda.synchronize(prog.device)
    window_s = time.perf_counter() - t0
    launches = {}
    for w, b in zip(prog.counters, before):
        for name, n in w.launches.items():
            launches[name] = (n - b.get(name, 0)) / steps
    return {"attempted": steps, "steps": steps, "words": steps * prog.batch,
            "window_s": window_s, "local_batch": prog.batch, "batches_per_rank": steps,
            "launches_per_batch": launches, "first": prog.first}


def release(prog: Program) -> None:
    prog.epoch = prog.params = prog.optimizer = None
    prog.counters.clear()


def _gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The worst leaf's gap between the two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref.values())
    return max((abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref if keep(k)), default=0.0)


def reference_steps(cfg: dict, traffic: dict, seed: int, device) -> dict:
    c, tr = cfg["code"], cfg["train"]
    code = RefCode.load(str(harness.path(c["file"])), c["z"], c["punct"], c["short"])
    T = tr["block"][1]
    if tr["sharing"][1] or tr["sharing"][0] not in (2, 3) or tr["sharing"][2] not in (2, 3):
        raise ValueError(f"the reference trains CN and VN weights of sharing 2 or 3, "
                         f"not {tr['sharing']}")
    width = lambda mode, n: 1 if mode == 3 else n
    weights = {"cn": np.full((T, width(tr["sharing"][0], c["M"])), tr["init_weight"], np.float32),
               "vn": np.full((T, width(tr["sharing"][2], c["N"])), tr["init_vn_weight"],
                             np.float32)}
    ref = RefTrainer(code, weights, T, tr["q_bit"], tr["clip_llr"], tr["learn_rate"],
                     tr["min_weight"], tr["max_weight"], device)
    start = {k: v.clone() for k, v in ref.params.items()}
    B = traffic["batch"]
    lanes = torch.as_tensor(sigmas(tr["snrs"], code.rate, B), device=device)
    gen = torch.Generator(device=device).manual_seed(train_seed(seed))
    losses, grad = [], None
    for i in range(traffic["checked_steps"]):
        noise = torch.randn((code.n_full, B), generator=gen, dtype=torch.float32,
                            device=device)
        loss, g = ref.step(noise, lanes)
        losses.append(loss)
        if i == 0:
            grad = {k: float(v.norm()) for k, v in g.items()}
    change = {k: float((ref.params[k] - start[k]).norm()) for k in start}
    return {"loss": losses, "grad": grad, "change": change}


def check(cfg: dict, traffic: dict, result: dict, seed: int, device, world=None) -> dict:
    got, ref = result["first"], reference_steps(cfg, traffic, seed, device)
    med = statistics.median(ref["grad"].values())
    moved = lambda k: ref["grad"][k] >= NEGLIGIBLE_GRAD * med
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
        "grad_gap": _gap(got["grad"], ref["grad"], lambda k: True),
        "change_gap": _gap(got["change"], ref["change"], moved),
    }
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    bad = sum(v > LIMITS[k] for k, v in numbers.items())
    return {"correct": bad == 0, "failed": int(bad > 0), "checks": checks,
            "detail": {"program": got, "reference": ref}}

"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It measures the PyTorch and CUDA port, `ldpc_error_floor_tpu_torch`, on
the card: set-up (imports, the kernels' libraries, parameters, a warm-up
on the window's shapes), then the window of `--seconds`, then, once the
window has closed and the program is freed, the plain reference's check.
With `--trace 1` the window runs under `torch.profiler` and the result
carries the cell's per-layer metrics; without, its end-to-end ones.  A cell
of W chips runs W ranks of an NCCL world, this process rank 0.

It exits non-zero and prints no result without a card (or with fewer cards
than the cell asks for), and when JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import counts, harness, mesh  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


class Phases:
    """Seconds of each named phase of set-up and check, printed on standard
    error as they end."""

    def __init__(self, rank: int = 0):
        self.seconds, self.rank = {}, rank

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        if self.rank == 0:
            print(f"portbench: {name} {self.seconds[name]:.3f} s", file=sys.stderr, flush=True)


class Spans:
    """The benchmark's own spans around each call into the program in the
    window: host-clock start and end, and a `record_function` range that the
    trace holds."""

    def __init__(self, on: bool):
        self.on, self.rows = on, []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
        self.rows.append((name, t0, time.perf_counter()))


def trace_dir(workload: str, rank: int) -> Path:
    """Where a traced run writes its trace and spans: under the run's TMPDIR."""
    d = Path(tempfile.gettempdir()) / "portbench" / f"{workload}.rank{rank}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", rank: int = 0, world=None, traffic=None,
             program_cfg=None) -> dict:
    """One run of `cell`: set-up, window, check and metrics.  `world`: this
    rank's `mesh.World` in a cell of more than one chip.  `traffic`
    replaces the cell's mix (the tests' small sizes); `program_cfg` the
    configuration the program is built from (the control), while the
    reference always reads the cell's own."""
    cfg = harness.config(bench, cell["config"])
    traffic = traffic or harness.traffic(cell["traffic"])
    drive = harness.kind_module(traffic["kind"])
    phases = Phases(rank)
    dev = torch.device(device)
    if world is not None:
        dev = world.device
    prog = drive.setup(program_cfg or cfg, traffic, dev, phases.phase, seed,
                       mesh=None if world is None else world.mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_START
    spans = Spans(trace)
    stop_together = (lambda done: done) if world is None else world.all_done
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    result = drive.window(prog, seed, seconds, spans.span, stop_together)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    drive.release(prog)
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary = None
    if prof is not None:
        with phases.phase("trace_export"):
            tdir = trace_dir(cell["name"], rank)
            prof.export_chrome_trace(str(tdir / "trace.json"))
            del prof
            summary = counts.trace_summary(str(tdir / "trace.json"))
            with open(tdir / "spans.json", "w") as f:
                json.dump({"spans": spans.rows,
                           "launches_per_batch": result["launches_per_batch"]}, f)
    if world is not None:
        result = world.pool(result, peak, summary)
        peak = result["memory_peak_bytes"]
    with phases.phase("check"):
        verdict = drive.check(cfg, traffic, result, seed, dev, world)
    if rank != 0:
        return {}
    ctx = {**result, "setup_s": setup_s, "cfg": cfg, "traffic": traffic,
           "chips": cell["chips"], "summary": summary,
           "word_iters_per_word": verdict.get("word_iters_per_word")}
    line = {"correct": bool(verdict["correct"]), "attempted": result["attempted"],
            "failed": verdict["failed"],
            "metrics": harness.read_metrics(bench, cell["name"], trace, ctx),
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if summary is not None:
        line["device"]["busy_s"] = result.get("busy_s", summary["device_busy_ms"] / 1e3)
        line["device"]["window_s"] = result["window_s"]
        ops = sorted(summary["kernel_ms"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k, v / 1e3] for k, v in ops],
                             "idle_gaps": [list(g) for g in summary["idle_gaps"]]}
    print(json.dumps({"phases_s": phases.seconds, "setup_s": setup_s,
                      "launches_per_batch": result["launches_per_batch"],
                      "detail": verdict.get("detail")}), flush=True)
    line["checks"] = verdict["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_bench()
    cell = harness.cell(bench, args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    with mesh.world_of(chips, args.rank, args.port, sys.argv[1:]) as world:
        line = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                        rank=args.rank, world=world)
    if args.rank != 0:
        return 0
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"portbench check: {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

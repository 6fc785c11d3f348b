"""Data parallelism of the port (`parallel/mesh.py`) on the CPU, over gloo.

* A world of one in this process: `simulate` (genie and syndrome stop, K =
  1 and 2), the harvester, one train step, a data-mode evaluation and the
  CLI's `simulate --mesh` equal the non-distributed port exactly (==), the
  generator's state after a point included.
* Two gloo ranks, each a process running this file's ``__main__`` (one
  launch shared by the module's tests, every process under a timeout):
  the pooled Monte-Carlo counters equal (==) the sum of both rank
  generators run in one process; a point killed at 128 frames and resumed
  to 256 from the ranks' ``.part`` checkpoints equals the uninterrupted
  run, and so does a harvest; each rank's harvest ``.part`` file holds
  exactly the rows of its rank generator and both ranks stop on the same
  batch; a collect-mode evaluation writes one file, the world of one's; a
  batch that does not divide raises; a world of one resuming the two
  ranks' checkpoints raises; `run_training` matches the run without a
  mesh within `tests/test_mesh_training.py`'s tolerance (rtol 1e-4, atol
  1e-6: the gradients' all-reduce sums in another order), rank 0 alone
  writing its files.
* Against the JAX package's mesh (the 8 virtual devices of
  `tests/conftest.py`): the two-rank `TrainStep` on an LLR batch split in
  halves against `make_train_step(mesh=data_mesh(8))` on the whole batch,
  loss rtol 1e-5 and weights rtol 1e-5 / atol 1e-7 (the tolerances of
  `tests/test_multiprocess.py`: the all-reduce sums in another order); the
  two-rank data-mode `Evaluator` against JAX's `Evaluator(mesh=
  data_mesh(8))` on the same rows, counters equal and the loss within rtol
  5e-6 (XLA's float32 mean, `ROADMAP.md` §3).

Worker: ``python tests/test_torch_mesh.py <rank> <world> <port> <outdir>``.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ldpc_error_floor_tpu_torch import cli  # noqa: E402
from ldpc_error_floor_tpu_torch.channel import AWGNChannel  # noqa: E402
from ldpc_error_floor_tpu_torch.codes import TannerGraph, get_code  # noqa: E402
from ldpc_error_floor_tpu_torch.io import read_uncor_file  # noqa: E402
from ldpc_error_floor_tpu_torch.models import (DecoderConfig, NMSDecoder,  # noqa: E402
                                               WeightSpec, params_from_numpy,
                                               params_to_numpy)
from ldpc_error_floor_tpu_torch.parallel import (DataMesh, data_mesh,  # noqa: E402
                                                 initialize_distributed,
                                                 rank_generator)
from ldpc_error_floor_tpu_torch.pipelines import (Evaluator, ExperimentConfig,  # noqa: E402
                                                  run_training)
from ldpc_error_floor_tpu_torch.sim import FERSimulator, UncorHarvester  # noqa: E402
from ldpc_error_floor_tpu_torch.training import (make_optimizer,  # noqa: E402
                                                 make_train_step)

WMAN = "wman_N0576_R34_z24"
T, B = 4, 64            # decode depth; the global Monte-Carlo batch
TRAIN_B, EVAL_B, EVAL_BATCHES = 16, 16, 3
EVAL_SNR = 3.5         # some words decode, some fail
TIMEOUT_S = 120


def _setup(device="cpu"):
    code = get_code(WMAN)
    graph = TannerGraph(code)
    spec = WeightSpec(sharing=(3, 3, 3), n_iters=T)
    dec = NMSDecoder(code, DecoderConfig(decoding_type=2, q_bit=5), spec,
                     graph=graph, device=device)
    ch = AWGNChannel(code, decoding_type=2, q_bit=5, device=device)
    return code, graph, spec, dec, ch


def _weights(spec, graph):
    """Weights in [0.7, 1.3] made with numpy from a seed."""
    rng = np.random.default_rng(7)
    return {k: None if spec.dim(k, graph) == 0 else rng.uniform(
        0.7, 1.3, (spec.n_rows(k), spec.dim(k, graph))).astype(np.float32)
        for k in ("cn", "ucn", "vn")}


def _llrs(code, n, snr, seed):
    """[N*z, n] channel LLRs of numpy noise through the port's `_llr` (the
    JAX package's operation order)."""
    rng = np.random.default_rng(seed)
    sigma = np.full((n,), np.float32(code.snr_sigmas([snr])[0]), np.float32)
    y = (-1.0 + rng.standard_normal((code.n_full, n)) * sigma).astype(np.float32)
    ch = AWGNChannel(code, decoding_type=2, q_bit=5, device="cpu")
    return ch._llr(torch.from_numpy(y), torch.from_numpy(sigma)).numpy()


def _counts(pt, code):
    """A point's integer counters from its rates."""
    out = {"frames": pt.frames,
           "bit_errors": round(pt.ber_last * pt.frames * code.n_full),
           "frame_errors": round(pt.fer_last * pt.frames)}
    if pt.avg_iters is None:
        out["genie"] = round(pt.fer_genie * pt.frames)
    else:
        out["undetected"] = round(pt.fer_undetected * pt.frames)
        out["iters"] = round(pt.avg_iters * pt.frames)
    return out


def _train_once(mesh, dec, spec, graph, llr, lr=1e-2):
    """One Adam step (soft FER, eta 0 unwindowed) on `llr`; (loss, weights)."""
    params = params_from_numpy(_weights(spec, graph), "cpu")
    opt = make_optimizer(params, lr)
    step = make_train_step(dec, spec, 2, 0, T, mesh=mesh)
    labels = torch.zeros((llr.shape[0], llr.shape[1]))
    loss = float(step(params, opt, torch.from_numpy(llr), labels, 0.0))
    return loss, {k: None if v is None else v.tolist()
                  for k, v in params_to_numpy(params).items()}


def _train_cfg(out_dir):
    """`tests/test_mesh_training.py`'s run_training configuration."""
    return ExperimentConfig(
        code="MACKAY_N96_K48", sharing=(3, 0, 3), decoding_type=1, iters_max=2,
        fixed_iter=0, iter_step=2, sampling_type=0, loss_type=0, opt_metric=2,
        etha_start=0.0, learn_rate_start=1e-2, batch_size=64, training_num=192,
        epochs=2, valid_flag=1, valid_num=128, snrs=[2.0, 3.0], seed=5, out_dir=out_dir)


def _collect_eval(mesh, dec, ch, params, path):
    """A fresh-noise evaluation that appends every never-corrected word to
    `path` (the collect mode of `run_training`)."""
    Evaluator(dec, ch, 2, batch=EVAL_B, compute_loss=False, mesh=mesh).run(
        params, ch.code.snr_sigmas([3.0, 3.5]), 2 * EVAL_B, 0.0,
        generator=torch.Generator().manual_seed(13), collect_uncor_path=path)


def _harvest(mesh, dec, ch, params, path, ckpt=None, **kw):
    """A harvest of every failing word at 1.5 dB, at most 4 a batch a rank."""
    h = UncorHarvester(dec, ch, batch=B, cap=4, mesh=mesh)
    h.collect(params, 1.5, torch.Generator().manual_seed(19), target_words=10 ** 9,
              out_file=path, ckpt_path=ckpt, ckpt_every_s=0.0, **kw)


# Monte-Carlo points of the two-rank run: (name, stop, K, SNR, seed)
POINTS = [("genie", "genie", 2, 2.0, 11), ("syndrome", "syndrome", 1, 2.0, 17)]


class _Killed(Exception):
    """A rank process killed in the middle of a point."""


def _worker(rank: int, world: int, port: str, outdir: str) -> int:
    """One rank of the two-rank run; writes its results to JSON."""
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=TIMEOUT_S)
    mesh = data_mesh(world, device="cpu")
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    out = {"rank": mesh.rank, "world": mesh.world}
    for name, stop, K, snr, seed in POINTS:
        sim = FERSimulator(dec, ch, batch=B, stop=stop, inner_steps=K, mesh=mesh)
        pt = sim.run_point(params, snr, torch.Generator().manual_seed(seed),
                           max_frames=4 * B, target_frame_errors=None)
        out[name] = _counts(pt, code)
    # kill at 128 frames, resume to 256, against the uninterrupted point
    sim = FERSimulator(dec, ch, batch=B, inner_steps=2, mesh=mesh)
    run = lambda **kw: _counts(sim.run_point(  # noqa: E731
        params, 2.5, torch.Generator().manual_seed(23),
        target_frame_errors=None, **kw), code)
    out["uninterrupted"] = run(max_frames=256)
    ck = os.path.join(outdir, "resume.json")
    out["killed"] = run(max_frames=128, ckpt_path=ck)
    out["resumed"] = run(max_frames=256, ckpt_path=ck)
    # a checkpoint flag raised on one rank comes back raised on both
    sigma = float(np.float32(code.snr_sigmas([2.5])[0]))
    out["due_flags"] = [sim._read(params, torch.Generator().manual_seed(29), sigma,
                                  due).get()[1]
                        for due in (mesh.rank == 0, mesh.rank == 1, False)]
    # a point checkpointed at every read, killed as its third read is
    # queued, resumed to 512 from its mid-run record
    out["uninterrupted_512"] = run(max_frames=512)
    ck_mid = os.path.join(outdir, "resume_mid.json")
    killing = FERSimulator(dec, ch, batch=B, inner_steps=2, mesh=mesh)
    queued = [0]

    def read_then_kill(*args):
        queued[0] += 1
        if queued[0] == 3:
            raise _Killed
        return FERSimulator._read(killing, *args)

    killing._read = read_then_kill
    try:
        killing.run_point(params, 2.5, torch.Generator().manual_seed(23),
                          target_frame_errors=None, max_frames=512,
                          ckpt_path=ck_mid, ckpt_every_s=0.0)
    except _Killed:
        pass
    with open(f"{ck_mid}.part{mesh.rank}") as f:
        rec = json.load(f)
    out["killed_mid"] = {"frames": rec["frames"], "done": rec["done"]}
    out["resumed_mid"] = run(max_frames=512, ckpt_path=ck_mid, ckpt_every_s=0.0)
    # one rank's unreadable checkpoint raises on both ranks, none waits
    if mesh.rank == 1:
        with open(f"{ck_mid}.part1", "w") as f:
            f.write("{not json")
    try:
        run(max_frames=1024, ckpt_path=ck_mid)
        out["unreadable_raises"] = ""
    except ValueError as e:
        out["unreadable_raises"] = str(e)
    harv = UncorHarvester(dec, ch, batch=B, cap=4, mesh=mesh)
    words = harv.collect(params, 1.5, torch.Generator().manual_seed(3),
                         target_words=12, max_frames=512,
                         out_file=os.path.join(outdir, "uncor.txt"))
    out["harvest"] = {"frames": harv.frames, "hits": harv.hits,
                      "words": int(words.shape[0])}
    raised = []
    for make in (lambda: FERSimulator(dec, ch, batch=B - 1, mesh=mesh),
                 lambda: UncorHarvester(dec, ch, batch=B - 1, mesh=mesh),
                 lambda: Evaluator(dec, ch, 2, batch=B - 1, mesh=mesh)):
        try:
            make()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["indivisible_raises"] = raised
    llr = _llrs(code, TRAIN_B, 2.5, seed=5)
    out["loss"], out["weights"] = _train_once(mesh, dec, spec, graph,
                                              np.ascontiguousarray(llr[:, mesh.lanes(TRAIN_B)]))
    rows = _llrs(code, EVAL_B * EVAL_BATCHES, EVAL_SNR, seed=9).T.copy()
    ev = Evaluator(dec, ch, 2, t_lo=1, batch=EVAL_B, mesh=mesh)
    res, _ = ev.run(params, [0.0], EVAL_B * EVAL_BATCHES, 0.5, data=rows)
    out["evaluate"] = res.tolist()
    _collect_eval(mesh, dec, ch, params, os.path.join(outdir, "collect_eval.txt"))
    # a harvest killed at 128 frames and resumed to 256, and one not killed
    _harvest(mesh, dec, ch, params, os.path.join(outdir, "whole.txt"), max_frames=256)
    for frames in (128, 256):
        _harvest(mesh, dec, ch, params, os.path.join(outdir, "resumed.txt"),
                 ckpt=os.path.join(outdir, "harvest.json"), max_frames=frames)
    res = run_training(_train_cfg(os.path.join(outdir, "train")), verbose=False,
                       device="cpu", mesh=mesh)
    out["train_history"] = [(h["train_loss"], h["metric"]) for h in res.history]
    out["train_params"] = {k: None if v is None else v.tolist()
                           for k, v in res.params.items()}
    with open(os.path.join(outdir, f"res_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank run: both results and its output directory."""
    out = str(tmp_path_factory.mktemp("mesh2"))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", port, out],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    res = []
    for r in range(2):
        with open(os.path.join(out, f"res_{r}.json")) as f:
            res.append(json.load(f))
    return res, out


@pytest.fixture(scope="module")
def world_of_one():
    """A world of one over gloo in this process."""
    made = not dist.is_initialized()
    mesh = data_mesh(device="cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _rank_generators(seed, world=2):
    """Each rank's generator of a world of `world`, derived in this process
    from one generator state."""
    gen = torch.Generator().manual_seed(seed)
    state = gen.get_state()
    out = []
    for r in range(world):
        gen.set_state(state)
        out.append(rank_generator(gen, DataMesh(r, world, torch.device("cpu"))))
    return out


# ----- rank generators ----------------------------------------------------------------------

def test_rank_generator_is_the_documented_function():
    gen = torch.Generator().manual_seed(4)
    one = DataMesh(0, 1, torch.device("cpu"))
    assert rank_generator(gen, one) is gen and rank_generator(gen, None) is gen
    state = gen.get_state().numpy().tobytes()

    def seed_of(tag):
        d = hashlib.blake2b(state + tag, digest_size=8).digest()
        return int.from_bytes(d, "little") >> 1

    r1 = rank_generator(gen, DataMesh(1, 2, torch.device("cpu")))
    assert r1.initial_seed() == seed_of((1).to_bytes(4, "little"))
    assert gen.initial_seed() == seed_of(b"next")
    # no two ranks, and no two successive derivations, share a seed
    seeds = {g.initial_seed() for g in _rank_generators(4, world=4)}
    again = rank_generator(gen, DataMesh(1, 2, torch.device("cpu")))
    assert len(seeds) == 4 and again.initial_seed() not in seeds | {r1.initial_seed()}


# ----- a world of one in this process ----------------------------------------------------

@pytest.mark.parametrize("stop,K", [("genie", 1), ("genie", 2), ("syndrome", 1),
                                    ("syndrome", 2)])
def test_world_of_one_simulate_equals_plain(world_of_one, stop, K):
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    pts, states = [], []
    for mesh in (None, world_of_one):
        sim = FERSimulator(dec, ch, batch=B, stop=stop, inner_steps=K, mesh=mesh)
        gen = torch.Generator().manual_seed(11)
        pt = sim.run_point(params, 2.0, gen, max_frames=6 * B,
                           target_frame_errors=None)
        pts.append({k: v for k, v in vars(pt).items()
                    if k not in ("seconds", "frames_per_sec")})
        states.append(gen.get_state())
    np.testing.assert_equal(pts[0], pts[1])  # the syndrome stop's NaN too
    assert pts[0]["frames"] == 6 * B
    assert torch.equal(states[0], states[1])


def test_world_of_one_harvest_equals_plain(world_of_one, tmp_path):
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    got = []
    for name, mesh in (("plain", None), ("mesh", world_of_one)):
        h = UncorHarvester(dec, ch, batch=B, cap=4, mesh=mesh)
        path = str(tmp_path / f"{name}.txt")
        words = h.collect(params, 1.5, torch.Generator().manual_seed(3),
                          target_words=12, max_frames=512, out_file=path)
        got.append((words, read_uncor_file(path), h.frames, h.hits))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert got[0][2:] == got[1][2:] and got[0][0].shape[0] >= 12


def test_world_of_one_train_step_and_evaluate_equal_plain(world_of_one):
    code, graph, spec, dec, ch = _setup()
    llr = _llrs(code, TRAIN_B, 2.5, seed=5)
    assert _train_once(None, dec, spec, graph, llr) == \
        _train_once(world_of_one, dec, spec, graph, llr)
    params = params_from_numpy(_weights(spec, graph), "cpu")
    rows = _llrs(code, EVAL_B * EVAL_BATCHES, EVAL_SNR, seed=9).T.copy()
    res = [Evaluator(dec, ch, 2, t_lo=1, batch=EVAL_B, mesh=mesh).run(
        params, [0.0], EVAL_B * EVAL_BATCHES, 0.5, data=rows)[0]
        for mesh in (None, world_of_one)]
    np.testing.assert_array_equal(res[0], res[1])


def test_cli_simulate_mesh_equals_plain(world_of_one, capsys, tmp_path):
    argv = ["simulate", "--code", WMAN, "--device", "cpu", "--iters", "3",
            "--snrs", "2.0", "2.5", "--batch", "32", "--max-frames", "64",
            "--inner-steps", "2"]
    lines = []
    for extra in ([], ["--mesh"]):
        assert cli.main(argv + extra) == 0
        lines.append([{k: v for k, v in json.loads(s).items()
                       if k not in ("seconds", "frames_per_sec")}
                      for s in capsys.readouterr().out.splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert dist.is_initialized()  # the group it did not make stays
    cfg = str(tmp_path / "base.json")
    cli.main(["init-config", "--out", cfg])
    with pytest.raises(ValueError, match="world has 1"):
        cli.main(["train", "--config", cfg, "--mesh", "--mesh-devices", "2",
                  "--device", "cpu"])


# ----- two gloo ranks ----------------------------------------------------------------------

def test_two_ranks_pool_the_per_rank_sum(two_ranks):
    """The pooled counters equal both rank generators run in one process,
    and both ranks hold them."""
    res, _ = two_ranks
    assert res[0]["world"] == 2 and [r["rank"] for r in res] == [0, 1]
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    for name, stop, K, snr, seed in POINTS:
        want = {}
        for g in _rank_generators(seed):
            sim = FERSimulator(dec, ch, batch=B // 2, stop=stop, inner_steps=K)
            pt = sim.run_point(params, snr, g, max_frames=2 * B,
                               target_frame_errors=None)
            for k, v in _counts(pt, code).items():
                want[k] = want.get(k, 0) + v
        assert res[0][name] == res[1][name] == want, name
        assert want["frame_errors"] > 0


def test_two_ranks_resume_equals_uninterrupted(two_ranks):
    res, out = two_ranks
    for r in res:
        assert r["killed"]["frames"] == 128
        assert r["resumed"] == r["uninterrupted"] == res[0]["uninterrupted"]
    assert res[0]["uninterrupted"]["genie"] > 0
    for rank in range(2):
        with open(os.path.join(out, f"resume.json.part{rank}")) as f:
            assert json.load(f)["world"] == 2


def test_two_ranks_checkpoint_on_the_same_read(two_ranks):
    """The checkpoint flag of either rank's timer reaches both ranks; a
    point checkpointed at every read and killed mid-run resumes from its
    last record to the uninterrupted run; an unreadable checkpoint on one
    rank raises on both."""
    res, _ = two_ranks
    for r in res:
        assert r["due_flags"] == [True, True, False]
        assert r["killed_mid"] == {"frames": 128, "done": False}
        assert r["resumed_mid"] == r["uninterrupted_512"] == res[0]["uninterrupted_512"]
        assert "cannot be read" in r["unreadable_raises"]
    assert "JSONDecodeError" in res[1]["unreadable_raises"]
    assert "JSONDecodeError" not in res[0]["unreadable_raises"]


def test_checkpoint_written_once_when_due(monkeypatch, tmp_path):
    """A timed checkpoint is written on one read: the read queued behind a
    due read is not due too."""
    from ldpc_error_floor_tpu_torch.sim import fer

    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    clock, saved = [0.0], []

    def tick():  # one second a call
        clock[0] += 1.0
        return clock[0]

    monkeypatch.setattr(fer.time, "perf_counter", tick)
    monkeypatch.setattr(fer, "_save_ckpt", lambda path, obj: saved.append(
        (obj["frames"], obj["done"])))
    sim = FERSimulator(dec, ch, batch=B, mesh=None)
    sim.run_point(params, 2.5, torch.Generator().manual_seed(23),
                  target_frame_errors=None, max_frames=8 * B,
                  ckpt_path=str(tmp_path / "ck.json"), ckpt_every_s=2.5)
    timed = [f for f, done in saved if not done]
    assert saved[-1] == (8 * B, True)
    assert len(timed) == len(set(timed)) >= 2
    assert all(b - a > B for a, b in zip(timed, timed[1:]))


def test_resume_under_another_world_size_raises(two_ranks, world_of_one):
    _, out = two_ranks
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    for mesh in (world_of_one, None):
        sim = FERSimulator(dec, ch, batch=B, inner_steps=2, mesh=mesh)
        with pytest.raises(ValueError, match="another size"):
            sim.run_point(params, 2.5, torch.Generator().manual_seed(23),
                          max_frames=256, target_frame_errors=None,
                          ckpt_path=os.path.join(out, "resume.json"))


def test_two_ranks_harvest_parts_hold_the_rank_rows(two_ranks):
    """Each rank's .part file holds its rank generator's rows; both ranks
    stop on the batch where the words kept by both reach the target."""
    res, out = two_ranks
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    sigma = float(np.float32(code.snr_sigmas([1.5])[0]))
    gens = _rank_generators(3)
    h = UncorHarvester(dec, ch, batch=B // 2, cap=4)
    rows = [[], []]
    n_words = frames = hits = 0
    while n_words < 12 and frames < 512:
        for r, g in enumerate(gens):
            count, picked = h._step(params, g, sigma)
            c = int(count)
            rows[r].append(picked[:, :min(c, 4)].T.numpy())
            n_words += min(c, 4)
            hits += c
        frames += B
    assert res[0]["harvest"]["frames"] == res[1]["harvest"]["frames"] == frames
    assert res[0]["harvest"]["hits"] == res[1]["harvest"]["hits"] == hits
    for r in range(2):
        want = np.concatenate(rows[r])
        assert want.shape[0] > 0 and res[r]["harvest"]["words"] == want.shape[0]
        np.testing.assert_array_equal(
            read_uncor_file(os.path.join(out, f"uncor.txt.part{r}")),
            read_uncor_file(_write_rows(out, r, want)))
    assert not os.path.exists(os.path.join(out, "uncor.txt"))


def _write_rows(out, r, rows):
    """`rows` through the Uncor format (the file rounds them)."""
    from ldpc_error_floor_tpu_torch.io import append_uncor_file
    path = os.path.join(out, f"want.part{r}")
    if os.path.exists(path):
        os.remove(path)
    append_uncor_file(path, rows)
    return path


def test_two_ranks_indivisible_batch_raises(two_ranks):
    res, _ = two_ranks
    assert res[0]["indivisible_raises"] == res[1]["indivisible_raises"] == [True] * 3


def test_two_ranks_harvest_resume_equals_uninterrupted(two_ranks):
    """Each rank's .part file of a harvest killed at 128 frames and resumed
    to 256 (its .part checkpoint) holds the rows of the one not killed."""
    _, out = two_ranks
    for r in range(2):
        whole = read_uncor_file(os.path.join(out, f"whole.txt.part{r}"))
        assert whole.shape[0] > 0
        np.testing.assert_array_equal(
            read_uncor_file(os.path.join(out, f"resumed.txt.part{r}")), whole)
        with open(os.path.join(out, f"harvest.json.part{r}")) as f:
            ck = json.load(f)
        assert ck["world"] == 2 and ck["frames"] == 256


def test_two_ranks_collect_mode_evaluation_writes_one_file(two_ranks, tmp_path):
    """Rank 0 writes the words every rank flagged, in lane order: the file
    of a world of one."""
    _, out = two_ranks
    code, graph, spec, dec, ch = _setup()
    params = params_from_numpy(_weights(spec, graph), "cpu")
    path = str(tmp_path / "collect_eval.txt")
    _collect_eval(None, dec, ch, params, path)
    want = read_uncor_file(path)
    assert 0 < want.shape[0] < 4 * EVAL_B
    np.testing.assert_array_equal(read_uncor_file(os.path.join(out, "collect_eval.txt")),
                                  want)
    assert not [f for f in os.listdir(out) if f.startswith("collect_eval.txt.")]


def test_two_ranks_run_training_matches_world_of_one(two_ranks, tmp_path):
    """Both ranks train on the global batch's lanes: the losses, metrics and
    weights of the run without a mesh within `tests/test_mesh_training.py`'s
    tolerance (rtol 1e-4, atol 1e-6); rank 0 alone wrote the files."""
    res, out = two_ranks
    ref = run_training(_train_cfg(str(tmp_path)), verbose=False, device="cpu")
    hist = [(h["train_loss"], h["metric"]) for h in ref.history]
    for r in res:
        assert r["train_history"] == res[0]["train_history"]
        assert r["train_params"] == res[0]["train_params"]
    np.testing.assert_allclose(res[0]["train_history"], hist, rtol=1e-4, atol=1e-6)
    for k, v in ref.params.items():
        if v is not None:
            np.testing.assert_allclose(res[0]["train_params"][k], v.numpy(), rtol=1e-4,
                                       atol=1e-6)
    assert sorted(os.listdir(os.path.join(out, "train"))) == sorted(os.listdir(tmp_path))


def test_two_rank_train_step_matches_jax_mesh(two_ranks):
    import jax
    import jax.numpy as jnp

    from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
    from ldpc_error_floor_tpu.codes import get_code as jax_get_code
    from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
    from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
    from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
    from ldpc_error_floor_tpu.parallel import data_mesh as jax_data_mesh
    from ldpc_error_floor_tpu.parallel import replicate as jax_replicate
    from ldpc_error_floor_tpu.training.train import make_optimizer as jax_optimizer
    from ldpc_error_floor_tpu.training.train import make_train_step as jax_train_step

    res, _ = two_ranks
    assert jax.device_count() == 8
    code, graph, spec, dec, ch = _setup()
    llr = _llrs(code, TRAIN_B, 2.5, seed=5)
    jcode = jax_get_code(WMAN)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=(3, 3, 3), n_iters=T)
    mesh = jax_data_mesh(8)
    opt = jax_optimizer(1e-2)
    jp = jax_replicate(mesh, {k: None if v is None else jnp.asarray(v)
                              for k, v in _weights(spec, graph).items()})
    st = jax_replicate(mesh, opt.init(jp))
    step = jax_train_step(JaxDecoder(jcode, JaxConfig(), jspec, graph=jgraph), jspec,
                          loss_type=2, train_start=0, train_end=T, optimizer=opt,
                          donate=False, mesh=mesh)
    (jp, _), loss = step(jp, st, jnp.asarray(llr), jnp.zeros_like(jnp.asarray(llr)),
                         jnp.float32(0.0))
    # the world of one's step, for the ranks' agreement with it
    loss1, w1 = _train_once(None, dec, spec, graph, llr)
    for r in res:
        assert r["loss"] == res[0]["loss"] and r["weights"] == res[0]["weights"]
    np.testing.assert_allclose(res[0]["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(res[0]["loss"], loss1, rtol=1e-5)
    for k, v in res[0]["weights"].items():
        if v is None:
            assert jp[k] is None
            continue
        np.testing.assert_allclose(v, np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(v, w1[k], rtol=1e-5, atol=1e-7)
        assert not np.allclose(v, _weights(spec, graph)[k])  # the step moved them


def test_two_rank_evaluate_matches_jax_mesh(two_ranks):
    import jax.numpy as jnp

    from ldpc_error_floor_tpu.channel import AWGNChannel as JaxChannel
    from ldpc_error_floor_tpu.codes import TannerGraph as JaxGraph
    from ldpc_error_floor_tpu.codes import get_code as jax_get_code
    from ldpc_error_floor_tpu.models import DecoderConfig as JaxConfig
    from ldpc_error_floor_tpu.models import NMSDecoder as JaxDecoder
    from ldpc_error_floor_tpu.models import WeightSpec as JaxSpec
    from ldpc_error_floor_tpu.parallel import data_mesh as jax_data_mesh
    from ldpc_error_floor_tpu.pipelines.evaluate import Evaluator as JaxEvaluator

    res, _ = two_ranks
    code, graph, spec, dec, ch = _setup()
    rows = _llrs(code, EVAL_B * EVAL_BATCHES, EVAL_SNR, seed=9).T.copy()
    jcode = jax_get_code(WMAN)
    jgraph = JaxGraph(jcode)
    jspec = JaxSpec(sharing=(3, 3, 3), n_iters=T)
    jev = JaxEvaluator(JaxDecoder(jcode, JaxConfig(), jspec, graph=jgraph),
                       JaxChannel(jcode), 2, t_lo=1, batch=EVAL_B,
                       mesh=jax_data_mesh(8))
    ref, _ = jev.run({k: None if v is None else jnp.asarray(v)
                      for k, v in _weights(spec, graph).items()},
                     [0.0], EVAL_B * EVAL_BATCHES, 0.5, data=rows)
    got = np.asarray(res[0]["evaluate"])
    assert res[1]["evaluate"] == res[0]["evaluate"]
    counts = np.array([EVAL_B * code.n_full, EVAL_B, EVAL_B])[:, None] * EVAL_BATCHES
    np.testing.assert_array_equal(np.rint(got[:3] * counts), np.rint(ref[:3] * counts))
    assert 0 < ref[1, 0] < 1  # some words decode, some fail
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-6)


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]))

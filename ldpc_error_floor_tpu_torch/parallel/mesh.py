"""Data parallelism over `torch.distributed` (port of
`ldpc_error_floor_tpu/parallel/mesh.py`).

The model is a few thousand scalar weights, replicated; the one axis of
parallelism is the codeword batch.  One process per device (a *rank*)
decodes a contiguous share of each batch's lanes, and the counters and
gradients are summed over the ranks with `all_reduce`: NCCL between cards,
gloo between CPU processes.  Where JAX folds a device's index into the key
(`jax.random.fold_in`), each rank here draws from a generator of its own
(`rank_generator`).

A world of W ranks is W processes that each call `initialize_distributed`
with the same coordinator address and W, and their own rank
(`parallel/launch.py` starts them, one per card of the host, for the CLI's
`--mesh`); without a coordinator, `data_mesh` builds a world of one in this
process, so the collective path also runs on one device.
"""

from __future__ import annotations

import datetime
import hashlib
import socket
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ldpc_error_floor_tpu_torch.utils import resolve_device

TIMEOUT_S = 600.0  # a collective that waits longer raises


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the world: its rank, the number of ranks
    and the device its lanes live on.  Its collectives run on the default
    process group."""
    rank: int
    world: int
    device: torch.device

    def lanes(self, batch: int) -> slice:
        """This rank's lanes of a global batch of `batch` lanes."""
        share = batch // self.world
        return slice(self.rank * share, (self.rank + 1) * share)


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    """The device of `rank`: ``cuda:{rank % device_count}`` for a card given
    without an index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: float = TIMEOUT_S) -> None:
    """Join a world of `num_processes` ranks as rank `process_id`, meeting at
    ``tcp://{coordinator_address}`` (host:port, where rank 0 listens).  A
    no-op without a coordinator.  The backend is NCCL for a card and gloo
    for the CPU; `backend` overrides it (gloo also carries CUDA tensors,
    which lets two ranks share one card, where NCCL refuses)."""
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id")
    dev = _rank_device(resolve_device(device), process_id)
    backend = backend or _backend(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = next(dist.rendezvous(f"tcp://{coordinator_address}", process_id,
                                 num_processes, timeout=timeout))[0]
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
            _one_rank_per_card(store, dev, process_id, num_processes)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg", store),
                            world_size=num_processes, rank=process_id,
                            timeout=timeout, **kw)


def _one_rank_per_card(store, dev: torch.device, rank: int, world: int) -> None:
    """Raise on every rank when two NCCL ranks of the world would share a
    card (NCCL refuses them, with an error that does not say so): each rank
    posts its host and card to the coordinator's store and reads all."""
    store.set(f"card/{rank}", f"{socket.gethostname()} cuda:{dev.index}")
    cards = [store.get(f"card/{r}").decode() for r in range(world)]
    for r, card in enumerate(cards):
        if cards.index(card) != r:
            raise ValueError(
                f"ranks {cards.index(card)} and {r} of {world} are both on {card}: "
                "NCCL takes one rank per card, so start at most as many ranks on "
                "a host as it has cards (gloo ranks may share one)")


def data_mesh(n_devices: Optional[int] = None, device="cuda") -> DataMesh:
    """The mesh of every rank of the world, one device per rank.  Without a
    process group it first builds a world of one over a store in this
    process.  `n_devices` must equal the world's size: JAX takes the first
    N of a process's devices, the port runs one process per device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dev = _rank_device(dev, 0)
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for {n_devices} devices; the world has {world} "
                         "ranks of one device each")
    return DataMesh(rank=rank, world=world, device=_rank_device(dev, rank))


def batch_constraint(mesh: Optional[DataMesh]) -> Callable:
    """``x -> this rank's lanes of x`` (the trailing axis: ``[nbits, B]``
    batches), contiguous; the identity without a mesh."""
    if mesh is None:
        return lambda x: x
    return lambda x: x[..., mesh.lanes(x.shape[-1])].contiguous()


def replicate(mesh: Optional[DataMesh], params):
    """Rank 0's parameter tensors on every rank (broadcast in place); a
    no-op without a mesh."""
    if mesh is not None:
        with torch.no_grad():
            for v in params.values():
                if v is not None:
                    dist.broadcast(v, 0)
    return params


def all_sum(mesh: Optional[DataMesh], t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place (the counters' psum); `t`
    itself without a mesh."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_max(mesh: DataMesh, values: List[int]) -> List[int]:
    """The largest of each value over the ranks (read on the host)."""
    t = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def gather_lanes(mesh: Optional[DataMesh], t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` along the trailing axis, in rank order: a global
    batch's lanes back in lane order, on every rank."""
    if mesh is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=-1)


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait until every rank gets here (what rank 0 wrote is then there)."""
    if mesh is not None:
        all_sum(mesh, torch.zeros(1, device=mesh.device)).tolist()


def _state_seed(generator: torch.Generator, tag: bytes) -> int:
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes() + tag,
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def rank_generator(generator: torch.Generator,
                   mesh: Optional[DataMesh]) -> torch.Generator:
    """This rank's generator for a run that draws from `generator` (the
    counterpart of folding the device's index into the key).

    In a world of one (or without a mesh) it is `generator` itself, so a
    world of one draws what the non-distributed path draws.  In a world of
    W > 1 it is a new generator on `generator`'s device seeded with the
    first 8 bytes (little-endian, shifted right by one) of the BLAKE2b
    digest of `generator`'s state bytes followed by the rank as 4
    little-endian bytes; `generator` is then seeded the same way from the
    tag ``b"next"``, so the next run on it draws other numbers.  Every rank
    holds the same `generator` state and moves it the same way, whatever W;
    no two ranks share a seed."""
    if mesh is None or mesh.world == 1:
        return generator
    out = torch.Generator(device=generator.device)
    out.manual_seed(_state_seed(generator, mesh.rank.to_bytes(4, "little")))
    generator.manual_seed(_state_seed(generator, b"next"))
    return out

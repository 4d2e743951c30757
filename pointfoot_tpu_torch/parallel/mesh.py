"""Data parallelism over ranks (pointfoot_tpu/parallel/mesh.py).

The JAX package shards the env batch over a 1-D ('dp',) device mesh and
lets XLA insert the all-reduces.  Here each rank is a process of a
`torch.distributed` group with one device: it holds rows
[r·B/W, (r+1)·B/W) of every (B, ...) env-batched tensor, parameters and
optimizer state are replicated, and the runner and PPO reduce across ranks
with the collectives below.  Without a process group (world size 1) every
function here is the identity, so the single-process code paths need no
branch of their own.

`init_distributed` takes the place of JAX's `multihost_init`, `Mesh` of the
device mesh, `env_sharding` of the batch sharding (the slice of rows a rank
holds), and `replicated` broadcasts a module's parameters and buffers from
rank 0.

The collectives (`all_gather_rows`, `all_reduce_sum_` and with it
`all_reduce_mean_`, and `same_rows`, which runs once, when an env attaches
the mesh) each run in a `dp.collective` span (utils/profiling.py) and add
the bytes this rank sends to the counter `dp.bytes`.  The span times the
host: NCCL enqueues its work, so the device's time is read from a profiler
trace.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import Collection, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.utils import profiling

# a lost rank raises after this long in a collective instead of hanging
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group: `nccl` for one card a rank, `gloo`
    on the CPU (or for ranks that share a card).

    The world size and rank default to torchrun's WORLD_SIZE and RANK, the
    rendezvous to its MASTER_ADDR / MASTER_PORT (``env://``).  At world
    size 1 it does nothing and returns False, as the JAX package's
    `multihost_init` does.  A failed init raises; no other backend is
    tried."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (the default
    process group)."""

    rank: int
    world_size: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The mesh of the default process group (world size 1 without one).

    `device` None or "cuda" is the card LOCAL_RANK (torchrun's; rank 0
    without it); a device with an index ("cuda:0", two ranks sharing one
    card) or "cpu" is taken as given.  Raises when no device is named and
    no GPU is present."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, world_size=world, device=dev)


def rank_seed(seed: int, rank: int) -> int:
    """A seed of its own for a rank's random stream, derived from
    (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def env_sharding(mesh: Mesh, batch: int) -> slice:
    """The rows of a (batch, ...) tensor that this rank holds.  Raises
    when the batch does not divide by the world size."""
    if batch % mesh.world_size:
        raise ValueError(f"a batch of {batch} does not divide over "
                         f"{mesh.world_size} ranks")
    b = batch // mesh.world_size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def _children(tree, replicate: Collection[str]):
    """(name, child) of a dataclass, dict, NamedTuple, tuple or list; the
    children named in `replicate` are left out."""
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        items = []
    return [(k, v) for k, v in items if k not in replicate]


def _batch(tree, dim: int, replicate: Collection[str]) -> int:
    """The largest size along `dim` of the tree's tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[dim] if tree.dim() > dim else -1
    sizes = [_batch(v, dim, replicate) for _, v in _children(tree, replicate)]
    return max(sizes, default=-1)


def _map_rows(fn, tree, dim: int, batch: int, replicate: Collection[str]):
    """`tree` with fn applied to every tensor whose size along `dim` is
    `batch`; other leaves, and the children named in `replicate` at any
    depth, unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.dim() > dim and tree.shape[dim] == batch \
            else tree

    def sub(k, v):
        return v if k in replicate else _map_rows(fn, v, dim, batch,
                                                  replicate)

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: sub(f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: sub(k, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sub(k, v) for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(i, v) for i, v in enumerate(tree))
    return tree


def shard_batch(tree, mesh: Mesh, batch: Optional[int] = None,
                replicate: Collection[str] = ()):
    """This rank's rows of every (batch, ...) tensor of a tree (dataclasses,
    dicts, NamedTuples, tuples, lists).  `batch` defaults to the largest
    leading dim; scalars and other leaves replicate, as do the fields or
    keys named in `replicate` at any depth.  Raises when the batch does not
    divide by the world size."""
    if batch is None:
        batch = _batch(tree, 0, replicate)
    rows = env_sharding(mesh, batch)
    return _map_rows(lambda x: x[rows], tree, 0, batch, replicate)


def _alone(mesh: Optional[Mesh]) -> bool:
    """Nothing to reduce with: no mesh, or one rank without a process
    group.  (One rank with a group runs the collectives, so that a
    one-card run drives its backend as a multi-card run does.)"""
    return mesh is None or (mesh.world_size == 1
                            and not dist.is_initialized())


def all_gather_rows(tree, mesh: Mesh, dim: int = 0,
                    batch: Optional[int] = None,
                    replicate: Collection[str] = ()):
    """The inverse of `shard_batch`: every rank's rows of each tensor whose
    size along `dim` is the local `batch` (default: the largest such
    size), concatenated in rank order along `dim`, on every rank.  A
    collective."""
    if _alone(mesh):
        return tree
    if batch is None:
        batch = _batch(tree, dim, replicate)

    def gather(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x)
        profiling.count("dp.bytes", x.numel() * x.element_size())
        return torch.cat(parts, dim=dim)

    with profiling.span("dp.collective"):
        return _map_rows(gather, tree, dim, batch, replicate)


def all_reduce_sum_(tensors: Sequence[torch.Tensor],
                    mesh: Optional[Mesh]) -> None:
    """Sum each tensor over the ranks, in place, in one collective (the
    tensors, of one dtype, are packed into one buffer): every rank
    receives the one result of the reduction."""
    if _alone(mesh) or not tensors:
        return
    with profiling.span("dp.collective"):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        profiling.count("dp.bytes", flat.numel() * flat.element_size())
        o = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[o:o + n].view_as(t))
            o += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     mesh: Optional[Mesh]) -> None:
    """The mean over the ranks of each tensor, in place: for per-rank means
    of equal shards, the global mean."""
    if _alone(mesh) or not tensors:
        return
    all_reduce_sum_(tensors, mesh)
    for t in tensors:
        t.div_(mesh.world_size)


def same_rows(mesh: Mesh, rows: int) -> None:
    """Raise unless every rank holds `rows` rows, i.e. the ranks hold the
    shards of a global batch that divides by the world size.  A
    collective, made once, when an env attaches the mesh
    (envs/legged_env.py, `shard_mesh`).  Without a process group there is
    no other rank to compare with, and it returns at once."""
    if mesh is None or not dist.is_initialized():
        return
    with profiling.span("dp.collective"):
        t = torch.tensor([rows, -rows], dtype=torch.int64,
                         device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        profiling.count("dp.bytes", t.numel() * t.element_size())
        hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise ValueError(f"rank {mesh.rank} holds {rows} rows, another rank "
                         f"between {lo} and {hi}: the rows are not the "
                         f"shards of one global batch over "
                         f"{mesh.world_size} ranks")


def replicated(module: torch.nn.Module, mesh: Optional[Mesh]
               ) -> torch.nn.Module:
    """Broadcast a module's parameters and buffers from rank 0, in place,
    so every rank starts from rank 0's values.  Returns the module."""
    if _alone(mesh):
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module

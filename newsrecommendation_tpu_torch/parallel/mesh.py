"""The (data, table) mesh mapped onto ranks: one process per device.

The JAX package runs one process over all devices, on a 2-D mesh whose
first axis carries data parallelism and whose second row-shards the
embedding table (newsrecommendation_tpu/parallel/mesh.py). The port runs
one process per rank, as the reference's DDP program does (main.py:31,
:82, :309): world = dp x ts, rank r sits at data index r // ts and table
index r % ts (the table axis inner, as in the JAX mesh), and two kinds of
process group carry the collectives:

  - a data group per table index: the ranks that hold the same table rows
    and see different batches (the gradient all-reduce);
  - a table group per data index: the ranks that see the same batch and
    hold different table rows (the row all-reduce of a sharded lookup).

A rank feeds ``cfg.batch_size`` rows; the global batch is batch_size x dp.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from newsrecommendation_tpu_torch.utils.device import rank_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (dp, ts) mesh, its two groups and device.

    ``data_group`` / ``table_group`` are None on a one-rank mesh run
    without a process group; the collectives then are the identity."""

    dp: int
    ts: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    table_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.dp * self.ts

    @property
    def data_index(self) -> int:
        return self.rank // self.ts

    @property
    def table_index(self) -> int:
        return self.rank % self.ts

    @property
    def trivial(self) -> bool:
        """One rank and no process group: the plain step is the same math."""
        return self.world == 1 and self.data_group is None


def mesh_shape(data_parallel: int, table_shards: int,
               n_devices: int) -> tuple:
    """(dp, ts) over n_devices, as the JAX package's make_mesh sizes it:
    data_parallel 0 takes every device left after table sharding; a mesh
    larger than the devices raises, naming the counts."""
    if table_shards < 1 or n_devices % table_shards != 0:
        raise ValueError(f"table_shards={table_shards} must divide "
                         f"{n_devices} devices")
    dp = data_parallel or (n_devices // table_shards)
    if dp * table_shards > n_devices:
        raise ValueError(
            f"mesh ({dp} x {table_shards}) needs {dp * table_shards} "
            f"devices, have {n_devices}")
    return dp, table_shards


def device_slots(device, data_parallel: int, table_shards: int) -> int:
    """The devices a launcher may spread ranks over: the CUDA cards, or on
    the CPU as many processes as the mesh asks for (data_parallel 0 is
    then one data index)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return max(data_parallel, 1) * table_shards


def make_mesh(cfg=None, *, data_parallel: int = 0, table_shards: int = 1,
              device="cuda") -> Mesh:
    """This rank's mesh over the initialised process group (or a one-rank
    mesh without one). The group's world must be dp x ts; data_parallel
    0 takes world // table_shards. ``device``: "cuda" without an index
    puts the rank on ``cuda:{LOCAL_RANK}``; an explicit one is kept.

    Every rank must call this, in the same order: it creates the groups
    (dist.new_group is collective over the world)."""
    if cfg is not None:
        data_parallel, table_shards = cfg.data_parallel, cfg.table_shards
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    dp, ts = mesh_shape(data_parallel, table_shards, world)
    if dp * ts != world:
        raise ValueError(f"mesh ({dp} x {ts}) needs a world of {dp * ts} "
                         f"ranks, the process group has {world}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank, backend)
    if backend is None:
        return Mesh(dp, ts, rank, dev)
    data_group = table_group = None
    for t in range(ts):  # a data group per table index
        g = dist.new_group([d * ts + t for d in range(dp)])
        if rank % ts == t:
            data_group = g
    for d in range(dp):  # a table group per data index
        g = dist.new_group([d * ts + t for t in range(ts)])
        if rank // ts == d:
            table_group = g
    return Mesh(dp, ts, rank, dev, data_group, table_group)


def owned_data_rows(mesh: Optional[Mesh]) -> list:
    """The data indices whose batch rows this rank feeds: its own one."""
    return [0] if mesh is None else [mesh.data_index]


def local_batch_size(mesh: Optional[Mesh], global_batch: int) -> int:
    """Rows of a global batch of ``global_batch`` this rank feeds."""
    if mesh is None:
        return global_batch
    if global_batch % mesh.dp:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{mesh.dp} data indices")
    return global_batch // mesh.dp


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This rank's rows of a global host batch (every array's leading
    axis split over the data indices), as tensors on the mesh's device."""
    if mesh is None:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        n = local_batch_size(mesh, v.shape[0])
        rows = v[mesh.data_index * n:(mesh.data_index + 1) * n]
        out[k] = torch.from_numpy(np.ascontiguousarray(rows)).to(mesh.device)
    return out


def replicate(mesh: Optional[Mesh], tensors, src: int = 0, check=False):
    """Make a nested dict of tensors equal on every rank: broadcast from
    rank ``src`` in place, or with check=True raise unless the ranks
    already agree bit for bit. Returns the tree."""
    if mesh is None or not (dist.is_available() and dist.is_initialized()):
        return tensors

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
            return
        if not check:
            with torch.no_grad():
                dist.broadcast(tree, src)
            return
        got = tree.detach().clone()
        dist.broadcast(got, src)
        if not torch.equal(got, tree.detach()):
            raise ValueError(f"rank {mesh.rank} holds another value than "
                             f"rank {src}")

    walk(tensors)
    return tensors


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (no-op without a process group)."""
    if mesh is not None and mesh.data_group is not None:
        dist.barrier()


def rank0_first(mesh: Optional[Mesh], fn):
    """Run ``fn`` on rank 0 only, then wait for every rank: files one rank
    writes and all read (the prepared behaviors shards)."""
    out = None
    if mesh is None or mesh.rank == 0:
        out = fn()
    barrier(mesh)
    return out

"""Data-parallel mesh (counterpart of convnets_tpu/parallel/mesh.py).

The JAX package runs one GSPMD program over a jax.sharding.Mesh: the batch
is sharded on the 'data' axis, the parameters and optimizer state are
replicated, XLA inserts the gradient all-reduce, and BN statistics are
reduced over the global batch. The port runs one process per card over a
torch.distributed process group, arranged as a DeviceMesh with a 'data'
dimension:
  * each rank takes a contiguous block of the global batch (`shard_batch`,
    what P('data') gives a device) or its loader's host slice;
  * every rank holds the same parameters and optimizer state (the Trainer
    broadcasts rank 0's weights, and every step applies the same summed
    gradient);
  * every batch-norm site sums its per-channel statistics over the data
    group (`data_sum_`, `data_mean_`) and divides by the global count, in
    the forward and in the backward, which is what the JAX package's
    reductions over a sharded axis compute;
  * the train step sums the gradients over the group as one flat fp32
    buffer: the global batch's gradient, as the JAX step takes it (a sum,
    not a mean over ranks).

The BN sites read the mesh that is active (`set_active_mesh`, or
`mesh_scope` around a region): the Trainer makes its mesh active while its
steps run, so a Trainer without a mesh in the same process reduces
nothing. With a mesh the collectives run at every world size, 1 included.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class _Active(NamedTuple):
    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis: str


# the mesh whose data group the BN sites reduce over; one process drives
# one mesh at a time (the JAX package's _ACTIVE_MESH)
_ACTIVE: Optional[_Active] = None


def set_active_mesh(mesh, axis_name: str = "data") -> None:
    global _ACTIVE
    _ACTIVE = None if mesh is None else _Active(mesh, axis_name)


def active_mesh():
    return None if _ACTIVE is None else _ACTIVE.mesh


@contextlib.contextmanager
def mesh_scope(mesh, axis_name: str = "data"):
    """Make `mesh` (or no mesh, for None) the active one inside the block,
    and restore the previous one after it."""
    global _ACTIVE
    before = _ACTIVE
    set_active_mesh(mesh, axis_name)
    try:
        yield
    finally:
        _ACTIVE = before


def data_group(mesh=None, axis_name: Optional[str] = None):
    """The process group of the data dimension of `mesh` (the active mesh
    when None), or None when there is no mesh."""
    if mesh is None:
        if _ACTIVE is None:
            return None
        mesh, axis_name = _ACTIVE
    return mesh.get_group(axis_name or "data")


def data_size(mesh=None, axis_name: Optional[str] = None) -> int:
    """The number of ranks in the data group (1 without a mesh)."""
    group = data_group(mesh, axis_name)
    return 1 if group is None else dist.get_world_size(group)


def data_rank(mesh=None, axis_name: Optional[str] = None) -> int:
    """This process's rank in the data group (0 without a mesh)."""
    group = data_group(mesh, axis_name)
    return 0 if group is None else dist.get_rank(group)


def data_sum_(t: torch.Tensor, n: int) -> int:
    """Sum `t` in place over the active mesh's data group, and return the
    global count beside it: n, this rank's count of the values summed into
    t, times the group's size (every rank holds a block of one shape).
    Without an active mesh, t is left as it is and n returned."""
    group = data_group()
    if group is None:
        return n
    dist.all_reduce(t, group=group)
    return n * dist.get_world_size(group)


def data_mean_(t: torch.Tensor) -> torch.Tensor:
    """Per-rank means of equal counts → their mean over the data group, in
    place (the identity without an active mesh; at one rank, bit for bit)."""
    world = data_sum_(t, 1)
    if world > 1:
        t.div_(world)
    return t


def global_count(n: int) -> int:
    """This rank's count n times the active data group's size."""
    return n * data_size()


class Sharding(NamedTuple):
    """Where an array lives on the mesh: split over `axis` (its leading,
    batch dimension, in contiguous per-rank blocks) or, with axis None,
    replicated on every rank."""

    mesh: object
    axis: Optional[str]


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda",
                     backend: Optional[str] = None) -> tuple:
    """Join (or start) the default process group; call once per process
    before make_mesh. Returns (rank, world size, local device count).

    coordinator: "host:port" or an init_method URL ("tcp://host:port",
    "file:///path") with num_processes and process_id; without it, under
    torchrun (WORLD_SIZE in the environment) torchrun's environment is
    read, and otherwise the process forms a world of one over an
    in-process store. backend: NCCL when `device` is the card, gloo on the
    CPU, unless given (gloo also runs on CUDA tensors: two ranks that
    share one card, where NCCL refuses two ranks on one device). On the
    card each rank takes the card LOCAL_RANK (or its rank) modulo the
    card count. An initialized group is kept as it is."""
    device = torch.device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise ValueError("init_distributed: a coordinator needs num_processes and "
                                 "process_id")
            url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
            rank, world = int(process_id), int(num_processes)
            kw = dict(init_method=url)
        elif "WORLD_SIZE" in os.environ:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            kw = dict(init_method="env://")
        else:
            rank, world = 0, 1
            kw = dict(store=dist.HashStore())
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    local_count = torch.cuda.device_count() if device.type == "cuda" else 1
    return dist.get_rank(), dist.get_world_size(), local_count


def _require_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialized process group: call "
                           "convnets_tpu_torch.parallel.init_distributed() first")


def make_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "data",
              mesh_shape=None):
    """A DeviceMesh over the ranks `devices` (every rank of the default
    group by default) with a data dimension named `axis_name`; with
    `mesh_shape` (an nD layout) the leading dimensions are named axis0,
    axis1, ... and the last is the data dimension, as in the JAX package.
    The mesh's device type is the card's where the group's backend is
    NCCL or this process has a current card, else the CPU."""
    _require_group("make_mesh")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.arange(dist.get_world_size()) if devices is None else np.asarray(devices)
    if mesh_shape is not None:
        ranks = ranks.reshape(mesh_shape)
        names = tuple(f"axis{i}" for i in range(ranks.ndim - 1)) + (axis_name,)
    else:
        names = (axis_name,)
    device_type = ("cuda" if dist.get_backend() == "nccl" or torch.cuda.is_available()
                   else "cpu")
    return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=names)


def data_sharding(mesh, axis_name: str = "data") -> Sharding:
    """Batch-dim sharding for (B, ...) arrays."""
    return Sharding(mesh, axis_name)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh, batch, axis_name: str = "data"):
    """This rank's contiguous block of each array of a global host batch
    (numpy arrays or tensors, batch first): rows [r·B/w, (r + 1)·B/w) on
    rank r of w, which is what P('data') places on device r."""
    world, rank = data_size(mesh, axis_name), data_rank(mesh, axis_name)
    out = []
    for b in batch:
        if b.shape[0] % world:
            raise ValueError(f"shard_batch: a batch of {b.shape[0]} does not split into "
                             f"{world} equal blocks")
        k = b.shape[0] // world
        out.append(b[rank * k:(rank + 1) * k])
    return tuple(out)


def mesh_backend(mesh, axis_name: str = "data") -> str:
    """The backend of the mesh's data group ("nccl", "gloo")."""
    return dist.get_backend(data_group(mesh, axis_name))


def broadcast_tensors(tensors, mesh, axis_name: str = "data") -> None:
    """Overwrite each tensor with data rank 0's, in place."""
    group = data_group(mesh, axis_name)
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def broadcast_object(obj, mesh, axis_name: str = "data"):
    """Data rank 0's `obj` (picklable), on every rank."""
    group = data_group(mesh, axis_name)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]

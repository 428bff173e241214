"""Device mesh and sharding helpers (counterpart of ``sed_tpu.parallel.mesh``).

``sed_tpu`` drives N devices from one process through a 1-D ``('data',)``
mesh: state is replicated, the batch axis is sharded, and XLA inserts the
gradient and BatchNorm all-reduces.  PyTorch's idiom is SPMD with one
process (rank) per device on ``torch.distributed``: NCCL on
``cuda:{local_rank}``, gloo on the CPU.  Every rank runs the same program on
identical host data and keeps only its own shard of a sharded array (the
contract of ``sed_tpu.parallel.multihost``).  A :class:`Mesh` is this rank's
view of such a group: the group, its size, this rank and its device.

The batch is cut into ``size`` equal contiguous shards, rank r holding rows
``[r * B / size, (r + 1) * B / size)``, as ``NamedSharding(mesh,
P('data'))`` places them; B must divide by the size.  Collectives go
through :func:`gather_rows`, :func:`all_reduce_sum_`, :func:`all_reduce_mean_`
and :func:`row_from_owner`; each takes ``mesh=None`` as one device, so the
callers keep one code path.

A train step takes the mesh as an argument (``step(..., mesh=)``, which
``parallel.data_parallel.shard_train_step`` passes): the augmentation is
drawn for the global batch, the batch norms normalize with the global batch
statistics (``models.layers.global_batch_norm``), and the gradients are
averaged over the ranks before the optimizer step
(``train.state.apply_update``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D data-parallel group: ``group`` (None: the
    default group), ``size`` ranks, this ``rank``, the ``device`` it owns,
    and ``axis_names`` (``('data',)``)."""

    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis_names: tuple = (DATA_AXIS,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array lives on a mesh: ``spec`` ``('data',)`` shards the
    leading axis, ``()`` replicates (``NamedSharding``'s PartitionSpec)."""

    mesh: Mesh
    spec: tuple = ()


def _default_device(backend: str) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = DATA_AXIS,
) -> Mesh:
    """1-D data-parallel mesh over the process group of ``n_devices`` ranks.

    The default process group must have exactly ``n_devices`` ranks
    (``multihost.initialize_multihost`` or ``multihost.launch`` set it up).
    With no group, ``create_mesh(1)`` creates a one-rank group itself: NCCL
    on the current CUDA device, or gloo when ``devices`` is ``['cpu']``;
    ``multihost.shutdown_multihost`` tears it down.  ``devices``: one torch
    device per rank (this rank takes ``devices[rank]``); by default the
    current CUDA device under NCCL, the CPU under gloo.

    NCCL's flight recorder stays as the process's environment has it
    (torch's default: on).  It costs host time on every collective, and a
    train step under a mesh is host-bound (PERF.md, section 6): a process
    that owns its environment may call ``multihost.nccl_flight_recorder_off``
    before its first collective, as the ranks of ``multihost.launch`` do.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"create_mesh({n_devices}) needs a process group of {n_devices} ranks, "
                "one process per device: start them with multihost.launch or "
                "torchrun, or call multihost.initialize_multihost in each")
        device = torch.device(devices[0] if devices else "cuda")
        if device.type == "cuda":
            from sed_tpu_torch.inference import resolve_device

            resolve_device(device)
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"create_mesh({n_devices}) on a process group of {size} ranks")
    rank = dist.get_rank()
    device = (torch.device(devices[rank]) if devices
              else _default_device(dist.get_backend()))
    return Mesh(None, size, rank, device, (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> Sharding:
    """Shard the leading (batch) axis across the mesh."""
    return Sharding(mesh, (axis_name,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def local_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's contiguous shard of ``n`` rows (all of them without a
    mesh); ``n`` must divide by the mesh size."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over the {mesh.size}-device mesh")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_device(mesh: Mesh, x):
    if isinstance(x, (torch.Tensor, torch.nn.Module)):
        return x.to(mesh.device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
    return x


def shard_batch(mesh: Mesh, batch, axis_name: str = DATA_AXIS):
    """This rank's contiguous slice of the leading axis of every array of
    ``batch`` (a tensor, an array or a tree of them), on its device.  Every
    rank passes the identical global batch."""

    def put(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
            return _to_device(mesh, x[local_rows(mesh, x.shape[0])])
        return _to_device(mesh, x)

    return _tree_map(put, batch)


def replicate(mesh: Mesh, tree):
    """Every array (and module) of ``tree`` on this rank's device; every
    rank passes identical values."""
    return _tree_map(lambda x: _to_device(mesh, x), tree)


def gather_rows(mesh: Optional[Mesh], t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' equal shards of a tensor concatenated along ``dim`` in
    rank order, on every rank (``t`` itself without a mesh)."""
    if mesh is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def row_from_owner(mesh: Optional[Mesh], local: torch.Tensor, b: int) -> torch.Tensor:
    """Row ``b`` of the global array whose shard on this rank is ``local``,
    on every rank: the owning rank broadcasts it (a copy of ``local[b]``
    without a mesh)."""
    if mesh is None:
        return local[b].clone()
    per = local.shape[0]
    owner = b // per
    row = local[b - owner * per].clone() if owner == mesh.rank \
        else local.new_empty(local.shape[1:])
    dist.broadcast(row, src=owner, group=mesh.group)
    return row


def all_reduce_sum_(mesh: Optional[Mesh], t: torch.Tensor) -> None:
    """In place: ``t`` becomes its sum over the ranks (unchanged without a
    mesh)."""
    if mesh is not None:
        dist.all_reduce(t, group=mesh.group)


def all_reduce_mean_(mesh: Optional[Mesh], tensors) -> None:
    """In place: each tensor (of one dtype) becomes its mean over the
    ranks, in one all-reduce of the tensors flattened together."""
    if mesh is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of ``mesh`` (nothing without a mesh)."""
    if mesh is not None:
        ids = [mesh.device.index] if mesh.device.type == "cuda" else None
        dist.barrier(group=mesh.group, device_ids=ids)

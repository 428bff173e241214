"""Process-group set-up and the rank launcher (counterpart of
``sed_tpu.parallel.multihost``).

``sed_tpu`` starts one process per host with ``jax.distributed.initialize``
and runs the same program SPMD.  Here every device has its own process
(rank): :func:`initialize_multihost` joins it to the group, NCCL for CUDA
and gloo for the CPU, and :func:`launch` starts the ranks of a run, either
spawning them (``torch.multiprocessing.spawn``) or, under ``torchrun``
(``WORLD_SIZE`` in the environment), joining the group that set up.

The SPMD input contract is ``sed_tpu``'s: every rank passes identical host
data, and :func:`global_shard_batch` keeps only this rank's slice of the
leading axis, :func:`global_replicate` a replica, each on this rank's
device.  Only the primary rank (:func:`is_primary_host`) writes outputs.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist


def nccl_flight_recorder_off() -> None:
    """Turn NCCL's flight recorder off in this process (and the processes it
    starts), unless the environment chose its buffer size
    (``TORCH_FR_BUFFER_SIZE``, formerly ``TORCH_NCCL_TRACE_BUFFER_SIZE``).
    torch reads the size once a process, so call it before the first
    collective.  The recorder keeps a trace of every collective for
    debugging hangs, at a cost in host time on each (PERF.md, section 6): a
    train step is host-bound and makes 2 collectives a BatchNorm layer.
    Only :func:`launch`'s ranks call it, which run in processes of their
    own; a library caller's environment is left alone."""
    if "TORCH_FR_BUFFER_SIZE" not in os.environ and \
            "TORCH_NCCL_TRACE_BUFFER_SIZE" not in os.environ:
        os.environ["TORCH_FR_BUFFER_SIZE"] = "0"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join this process to the group as rank ``process_id`` of
    ``num_processes`` (a no-op when ``num_processes <= 1``).

    ``coordinator_address``: a ``tcp://host:port`` or ``file://path`` init
    method, or ``host:port``; None reads ``torchrun``'s environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``device``
    'cuda' joins over NCCL on ``cuda:{LOCAL_RANK}`` (the rank modulo the
    visible cards without it), set as the current device first; 'cpu' over
    gloo.
    """
    if num_processes is not None and num_processes <= 1:
        return
    init = coordinator_address or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    kind = torch.device(device).type
    if kind == "cuda":
        rank = process_id if process_id is not None else int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)


def shutdown_multihost() -> None:
    """Destroy the default process group, if there is one, so that later
    work in the process sees none."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary_host() -> bool:
    """True on rank 0, and when no process group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_put(mesh, tree, spec=None):
    """Place identical host data on every rank of ``mesh``: with ``spec``
    ``('data',)`` (or a ``Sharding`` of it) this rank's slice of each
    array's leading axis, else a replica; each on this rank's device."""
    from sed_tpu_torch.parallel.mesh import replicate, shard_batch

    spec = getattr(spec, "spec", spec)
    return shard_batch(mesh, tree) if spec else replicate(mesh, tree)


def global_replicate(mesh, tree):
    """Replicate identical host data (state, packed buffers) on every rank."""
    return global_put(mesh, tree, None)


def global_shard_batch(mesh, batch, axis_name: str = "data"):
    """This rank's slice of the leading axis of an identical global batch."""
    return global_put(mesh, batch, (axis_name,))


def check_num_devices(num_devices: int, device) -> None:
    """``sed_tpu``'s refusal of more ranks than visible devices: the CUDA
    cards with ``device`` 'cuda'; the CPU takes any number of gloo ranks."""
    if num_devices > 1 and torch.device(device).type == "cuda" \
            and torch.cuda.device_count() < num_devices:
        raise SystemExit(f"--num_devices {num_devices} but only "
                         f"{torch.cuda.device_count()} devices are visible")


def _rank_main(rank: int, fn: Callable, world: int, device, init: str, args) -> None:
    nccl_flight_recorder_off()
    initialize_multihost(init, world, rank, device=device)
    try:
        if rank:   # one process writes the run's standard output
            sys.stdout = open(os.devnull, "w")
        fn(*args)
    finally:
        shutdown_multihost()


def launch(fn: Callable, num_processes: int, device="cuda", args=()) -> None:
    """Run ``fn(*args)`` on ``num_processes`` ranks, one process per device,
    each joined to one group (:func:`initialize_multihost`) and torn down
    after.  Under ``torchrun`` (``WORLD_SIZE`` set) this process is one of
    the ranks and joins the group it set up; otherwise the ranks are
    spawned here, over a file store in a fresh temporary directory.  Each
    rank turns NCCL's flight recorder off (:func:`nccl_flight_recorder_off`)
    before it joins.  A rank that raises makes the call raise (the others
    are stopped); the other ranks' standard output is discarded.  ``fn`` and ``args`` must be
    picklable (a module-level function)."""
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != num_processes:
            raise SystemExit(f"--num_devices {num_processes} but torchrun started "
                             f"{world} processes")
        _rank_main(int(os.environ["RANK"]), fn, world, device, "env://", args)
        return
    root = tempfile.mkdtemp(prefix="sed_tpu_torch_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, num_processes, device, f"file://{root}/store", args),
            nprocs=num_processes, join=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run_with_mesh(run: Callable, num_devices: int, args) -> None:
    from sed_tpu_torch.parallel.mesh import create_mesh

    run(*args, mesh=create_mesh(num_devices))


def run_on_devices(run: Callable, num_devices: int, device="cuda", args=()) -> None:
    """A CLI's ``run(*args)``: in this process when ``num_devices`` is 1,
    else ``run(*args, mesh=create_mesh(num_devices))`` on each of
    ``num_devices`` ranks (:func:`launch`), after :func:`check_num_devices`.
    ``run`` must be a module-level function."""
    if num_devices <= 1:
        run(*args)
        return
    check_num_devices(num_devices, device)
    launch(_run_with_mesh, num_devices, device, args=(run, num_devices, args))

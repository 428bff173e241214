"""Data-parallel training and inference over a mesh (counterpart of
``sed_tpu.parallel.data_parallel``).

``sed_tpu`` jits its step with the state and buffers replicated and the
start indices sharded, and XLA inserts the gradient and BatchNorm
all-reduces.  Here each rank runs the raw step on its slice of the start
indices and passes it the mesh (``step(..., mesh=)``); with it the step
itself does what the partitioner does for ``sed_tpu``:

  * the BatchNorm layers normalize with the global batch mean and biased
    variance, all-gathered in the forward, and all-reduce the sums their
    input gradient needs in the backward (``models.layers``);
  * the gradients are averaged over the ranks before the optimizer step
    (``train.state.apply_update``), so every rank ends with the same state;
  * the augmentation is drawn for the global batch from the generator every
    rank holds, and each rank keeps its rows (``data.device_pipeline``).

With equal shards the step equals the single-device step on the global
batch, up to the order of the float sums.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from sed_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, gather_rows, local_rows


def shard_train_step(
    raw_step: Callable,
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    steps_per_call: int = 1,
) -> Callable:
    """``step(state, buffers, starts, generator=None) -> loss`` over the
    mesh: ``raw_step`` (a ``device_pipeline`` step, or a
    ``make_multi_step`` of K steps when ``steps_per_call`` > 1) runs on this
    rank's slice of the (B,) start indices, or of the batch axis of a
    (K, B) block, given ``mesh=mesh``; the returned loss (or K losses) is
    the global mean, the same on every rank.  The global batch must divide
    by the mesh size."""

    def step(state, buffers, starts, generator=None):
        starts = starts if isinstance(starts, torch.Tensor) else np.asarray(starts)
        expected = 1 if steps_per_call == 1 else 2
        if starts.ndim != expected:
            raise ValueError(f"starts must have {expected} axes with steps_per_call="
                             f"{steps_per_call}, got shape {tuple(starts.shape)}")
        local = starts[..., local_rows(mesh, starts.shape[-1])]
        loss = raw_step(state, buffers, local, generator, mesh=mesh).clone()
        dist.all_reduce(loss, group=mesh.group)
        return loss / mesh.size

    return step


def shard_inference(forward: Callable, mesh: Mesh, axis_name: str = DATA_AXIS) -> Callable:
    """``forward(x) -> (B, ...)`` with the batch sharded over the mesh: each
    rank runs ``forward`` on its slice of ``x``'s leading axis (sliced
    before any upload, for a host array) and every rank returns the global
    result, gathered in rank order.  Recordings are independent, so the
    forward itself communicates nothing."""

    def sharded(x):
        return gather_rows(mesh, forward(x[local_rows(mesh, x.shape[0])]))

    return sharded

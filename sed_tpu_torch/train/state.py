"""Train state and the train/eval step builders (counterpart of
``sed_tpu.train.state``).

``sed_tpu`` keeps parameters, BatchNorm statistics, optimizer state and the
step counter in one immutable pytree and jit-compiles one step.  Here the
state is the module itself (parameters and BatchNorm buffers), its
optimizer, the learning-rate scheduler and the step count, and a step
updates them in place.  The device and the random draws are explicit: the
model is initialized from a seeded ``torch.Generator`` and lives on the
device it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from sed_tpu_torch.parallel.mesh import all_reduce_mean_
from sed_tpu_torch.train.loss import weighted_bce_with_logits
from sed_tpu_torch.train.optim import make_optimizer
from sed_tpu_torch.utils.precision import full_float32


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_state(model: torch.nn.Module, lr: float, device="cuda",
               seed: Optional[int] = None) -> TrainState:
    """``model`` on ``device`` with a fresh optimizer and schedule at step 0.

    With ``seed``, the parameters are drawn anew from a CPU
    ``torch.Generator`` seeded with it (``model.reset_parameters``) before
    the move, so the weights do not depend on the device; without, the
    model keeps the weights it has.
    """
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device)
    optimizer, scheduler = make_optimizer(model, lr)
    return TrainState(model, optimizer, scheduler, 0)


def apply_update(state: TrainState, loss: torch.Tensor, mesh=None) -> None:
    """Backward, the AMSGrad update, the schedule's step and the count
    (profiler ranges ``train_step/backward`` and ``train_step/optimizer``).
    The gradients stay on the parameters until the next update.  With a
    ``mesh`` (``parallel.mesh.Mesh``) the gradients are averaged over its
    ranks before the update, so that every rank applies the same one."""
    with record_function("train_step/backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_mean_(mesh, [p.grad for p in state.model.parameters()
                                if p.grad is not None])
    with record_function("train_step/optimizer"):
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1


def make_train_step(
    pos_weight: float = 5.0,
    multi_frame: bool = True,
    augment_fn: Optional[Callable] = None,
) -> Callable:
    """Build ``step(state, x, y, generator=None) -> loss`` on ready batches.

    ``augment_fn(generator, x, y) -> (x, y)`` runs first when given.  The
    model runs in training mode (BatchNorm on the batch's statistics,
    updating its running ones); the returned loss is detached.  Each step
    runs in full float32 (``utils.precision.full_float32``).
    """

    @full_float32()
    def step(state: TrainState, x, y, generator=None):
        if augment_fn is not None:
            x, y = augment_fn(generator, x, y)
        state.model.train()
        loss = weighted_bce_with_logits(state.model(x), y, pos_weight, multi_frame)
        apply_update(state, loss)
        return loss.detach()

    return step


def make_eval_forward(model: torch.nn.Module) -> Callable:
    """``forward(x)``: the model in evaluation mode (running BatchNorm
    statistics; the call puts it there and leaves it there), without
    autograd, in full float32."""

    @full_float32()
    def forward(x):
        model.eval()
        with torch.inference_mode():
            return model(x)

    return forward

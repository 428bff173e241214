"""Checkpoints: full-state save and restore, and the reference's model-only
load (counterpart of ``sed_tpu.train.checkpoint``).

The format is the port's own: ``torch.save`` of ``{"model": state_dict,
"optimizer": ..., "scheduler": ..., "step": n}`` in
``checkpoints/iteration_{n}.pt``, loadable with ``weights_only=True``.  The
``model`` entry carries the reference's state-dict keys, so
``cli/infer.load_model`` reads the file as it is.

:func:`read_model_weights` reads the weights of every checkpoint a user may
hold: the port's ``.pt``, the reference's ``.pth`` and ``sed_tpu``'s msgpack
``.ckpt`` (through :mod:`sed_tpu_torch.train.flax_ckpt`).  A full resume
(:func:`load_checkpoint`) reads the port's ``.pt`` and ``sed_tpu``'s
``.ckpt``: its optax AMSGrad state becomes ``torch.optim.Adam``'s
(:func:`adam_state_from_optax`) and its schedule's count the ``LambdaLR``'s
epoch, so a run started under ``sed_tpu`` continues here.
:func:`latest_checkpoint` counts the files of both packages.  ``sed_tpu``'s
``.ckpt.orbax`` directories are refused by name.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.train.optim import lr_factor
from sed_tpu_torch.train.state import TrainState

SUFFIX = ".pt"
FLAX_SUFFIX = ".ckpt"
ORBAX_SUFFIX = ".ckpt.orbax"
# optax's AMSGrad moments (sed_tpu.train.optim) -> torch Adam's.
OPTAX_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "nu_max": "max_exp_avg_sq"}
# Parameters with no sed_tpu counterpart, which Adam never steps: the
# reference MobileNetV1's bn0, which its forward never calls.
NO_FLAX_COUNTERPART = {"MobileNetV1": ("bn0.weight", "bn0.bias")}


def checkpoint_path(outputs_dir: str, iteration: int) -> str:
    return os.path.join(outputs_dir, "checkpoints", f"iteration_{iteration}{SUFFIX}")


def save_checkpoint(state: TrainState, outputs_dir: str, iteration: int) -> str:
    """Save model, optimizer, schedule and step; returns the path."""
    path = checkpoint_path(outputs_dir, iteration)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": int(state.step)}, path)
    return path


def _refuse_orbax(path: str) -> None:
    if path.rstrip(os.sep).endswith(ORBAX_SUFFIX) or os.path.isdir(path):
        raise ValueError(
            f"{path} is a sed_tpu orbax checkpoint directory, which the port does not "
            f"read (see ROADMAP.md); save it with sed_tpu's msgpack backend "
            f"(save_checkpoint(..., backend='msgpack'), the default) and pass the "
            f"{FLAX_SUFFIX} file")


def _arch_of(model: torch.nn.Module) -> str:
    from sed_tpu_torch.models.convert import FLAX_CONVERTERS

    arch = type(model).__name__
    if arch not in FLAX_CONVERTERS:
        raise ValueError(f"a sed_tpu checkpoint restores {sorted(FLAX_CONVERTERS)}, "
                         f"not a {arch}")
    return arch


def adam_state_from_optax(opt_state, arch: str, model: torch.nn.Module, batch_stats):
    """``(state, count)``: ``torch.optim.Adam``'s per-parameter state for
    ``model`` (a dict keyed by the parameter's index in
    ``model.parameters()``, what ``Adam.state_dict()['state']`` holds) from
    ``sed_tpu``'s optax state ``{"0": {count, mu, nu, nu_max}, "1":
    {count}}``, and the schedule's count.

    Each moment tree goes through ``arch``'s converter, as the parameters
    do (HWIO -> OIHW, the dense layers transposed); ``count`` becomes each
    parameter's ``step``, a float32 scalar, as Adam keeps it when not
    capturable.  A parameter with no ``sed_tpu`` counterpart (MobileNetV1's
    ``bn0``, which the forward never calls) gets no state, as Adam never
    steps it."""
    from sed_tpu_torch.models.convert import FLAX_CONVERTERS

    try:
        amsgrad, schedule = opt_state["0"], opt_state["1"]
        count = int(np.asarray(amsgrad["count"]))
        # The converters map a whole model: the statistics ride along, unused.
        trees = {name: FLAX_CONVERTERS[arch](amsgrad[key], batch_stats)
                 for key, name in OPTAX_MOMENTS.items()}
        schedule_count = int(np.asarray(schedule["count"]))
    except (KeyError, TypeError) as e:
        raise ValueError(f"not sed_tpu's optax state (AMSGrad, then the schedule): "
                         f"missing {e}") from None
    skip = NO_FLAX_COUNTERPART.get(arch, ())
    state = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        if name in skip:
            continue
        entry = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for moment, tree in trees.items():
            t = tree[name]
            if t.shape != p.shape:
                raise ValueError(f"{moment} of {name}: {tuple(t.shape)}, the parameter "
                                 f"is {tuple(p.shape)}")
            entry[moment] = t
        state[i] = entry
    return state, schedule_count


def _resume_from_flax(path: str, template: TrainState, model_only: bool) -> TrainState:
    """:func:`load_checkpoint` of a ``sed_tpu`` ``.ckpt``."""
    from sed_tpu_torch.models.convert import FLAX_CONVERTERS
    from sed_tpu_torch.train.flax_ckpt import read_flax_checkpoint

    arch = _arch_of(template.model)
    tree = read_flax_checkpoint(path)
    try:
        weights = FLAX_CONVERTERS[arch](tree["params"], tree["batch_stats"])
    except KeyError as e:
        raise ValueError(f"{path} does not hold a sed_tpu {arch}: no {e} in its "
                         f"parameters") from None
    template.model.load_state_dict(weights, strict=True)
    if model_only:
        return template
    state, count = adam_state_from_optax(tree["opt_state"], arch, template.model,
                                         tree["batch_stats"])
    optimizer = template.optimizer.state_dict()
    for group in optimizer["param_groups"]:
        group["lr"] = group["initial_lr"] * lr_factor(count)
    optimizer["state"] = state
    template.optimizer.load_state_dict(optimizer)
    scheduler = template.scheduler.state_dict()
    scheduler.update(last_epoch=count, _step_count=count + 1,
                     _last_lr=[g["lr"] for g in template.optimizer.param_groups])
    template.scheduler.load_state_dict(scheduler)
    template.step = int(np.asarray(tree["step"]))
    return template


def load_checkpoint(path: str, template: TrainState, model_only: bool = False) -> TrainState:
    """Restore a checkpoint into ``template`` (in place; it is returned).

    ``path``: the port's ``iteration_{n}.pt`` or ``sed_tpu``'s msgpack
    ``iteration_{n}.ckpt`` of the template's model family.  From a
    ``.ckpt``: the weights and BatchNorm statistics through
    ``models/convert.FLAX_CONVERTERS``, the AMSGrad moments and counts
    (:func:`adam_state_from_optax`), each group's ``lr`` at the schedule's
    count (``base_lr * lr_factor(count)``, ``base_lr`` the template's, as
    ``sed_tpu`` stores no schedule either) with the ``LambdaLR`` at that
    epoch, and the step.  Every rank of a mesh loads the same file.

    ``model_only=True`` mirrors the reference resume (main.py:37-39): the
    weights and BatchNorm statistics only, keeping the template's fresh
    optimizer, schedule and step.  An orbax directory is refused by name.
    """
    _refuse_orbax(path)
    if path.endswith(FLAX_SUFFIX):
        return _resume_from_flax(path, template, model_only)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    template.model.load_state_dict(ckpt["model"], strict=True)
    if not model_only:
        template.optimizer.load_state_dict(ckpt["optimizer"])
        template.scheduler.load_state_dict(ckpt["scheduler"])
        template.step = int(ckpt["step"])
    return template


def read_model_weights(path: str, arch: str):
    """``(state_dict, step)`` of a checkpoint of model family ``arch``
    (CnnAvgPooling, MobileNetV1 or M5), on the CPU with the reference's keys.

    Reads a ``sed_tpu`` msgpack ``.ckpt`` (its params and batch statistics
    through ``models/convert.py``; ``step``: its step), or anything
    ``torch.load`` reads with ``weights_only=True``: the port's
    ``iteration_{n}.pt`` (``step``: its step), the reference container
    ``{'iterations', 'model', ...}`` (``step``: its iterations) or a bare
    state dict (``step`` 0).  ``sed_tpu``'s ``.ckpt.orbax`` directories are
    refused by name.
    """
    from sed_tpu_torch.models.convert import FLAX_CONVERTERS

    if arch not in FLAX_CONVERTERS:
        raise ValueError(f"unknown arch {arch!r}")
    _refuse_orbax(path)
    if path.endswith(FLAX_SUFFIX):
        from sed_tpu_torch.train.flax_ckpt import read_flax_checkpoint

        tree = read_flax_checkpoint(path)
        return (FLAX_CONVERTERS[arch](tree["params"], tree["batch_stats"]),
                int(np.asarray(tree["step"])))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in ckpt:
        return ckpt, 0
    return ckpt["model"], int(ckpt.get("step", ckpt.get("iterations", 0)))


def latest_checkpoint(outputs_dir: str) -> Optional[str]:
    """The run's ``iteration_{n}`` checkpoint with the largest n, ties
    broken by the latest mtime, as ``sed_tpu`` breaks them; None when there
    is none.  The port's ``.pt``, ``sed_tpu``'s ``.ckpt`` and its
    ``.ckpt.orbax`` directories all count, so a run started under
    ``sed_tpu`` resumes here; an orbax directory that wins is refused when
    loaded, never passed over for an older file."""
    ckpt_dir = os.path.join(outputs_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = []
    for name in os.listdir(ckpt_dir):
        suffix = next((x for x in (ORBAX_SUFFIX, FLAX_SUFFIX, SUFFIX) if name.endswith(x)),
                      None)
        if suffix and name.startswith("iteration_"):
            try:
                candidates.append((int(name[len("iteration_"):-len(suffix)]), name))
            except ValueError:
                pass
    if not candidates:
        return None

    def sort_key(item):
        it, name = item
        return (it, os.path.getmtime(os.path.join(ckpt_dir, name)), name)

    return os.path.join(ckpt_dir, max(candidates, key=sort_key)[1])

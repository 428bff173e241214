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
(:func:`load_checkpoint`) reads the port's own files only: ``sed_tpu``'s
optax optimizer state is not mapped.  ``sed_tpu``'s ``.ckpt.orbax``
directories are refused by name.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.train.state import TrainState

SUFFIX = ".pt"
FLAX_SUFFIX = ".ckpt"
ORBAX_SUFFIX = ".ckpt.orbax"
SED_TPU_SUFFIXES = (FLAX_SUFFIX, ORBAX_SUFFIX)


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


def load_checkpoint(path: str, template: TrainState, model_only: bool = False) -> TrainState:
    """Restore a checkpoint into ``template`` (in place; it is returned).

    ``model_only=True`` mirrors the reference resume (main.py:37-39): the
    weights and BatchNorm statistics only, keeping the template's fresh
    optimizer, schedule and step.
    """
    if path.rstrip(os.sep).endswith(SED_TPU_SUFFIXES):
        raise ValueError(
            f"{path} is a sed_tpu (flax) checkpoint; a full resume reads the port's "
            f"own iteration_{{n}}{SUFFIX} files (sed_tpu's optimizer state is not "
            f"mapped, see ROADMAP.md). Its weights load through "
            f"cli.infer.load_model_and_state, or convert it with "
            f"python -m sed_tpu_torch.cli.export_torch")
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
    if path.rstrip(os.sep).endswith(ORBAX_SUFFIX) or os.path.isdir(path):
        raise ValueError(
            f"{path} is a sed_tpu orbax checkpoint directory, which the port does not "
            f"read (see ROADMAP.md); save it with sed_tpu's msgpack backend "
            f"(save_checkpoint(..., backend='msgpack'), the default) and pass the "
            f"{FLAX_SUFFIX} file")
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
    """The run's ``iteration_{n}.pt`` with the largest n, ties broken by the
    latest mtime; None when there is none.  Only the port's own files count,
    so a ``sed_tpu`` run directory is never resumed from."""
    ckpt_dir = os.path.join(outputs_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("iteration_") and name.endswith(SUFFIX):
            try:
                candidates.append((int(name[len("iteration_"):-len(SUFFIX)]), name))
            except ValueError:
                pass
    if not candidates:
        return None

    def sort_key(item):
        it, name = item
        return (it, os.path.getmtime(os.path.join(ckpt_dir, name)), name)

    return os.path.join(ckpt_dir, max(candidates, key=sort_key)[1])

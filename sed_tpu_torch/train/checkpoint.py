"""Checkpoints: full-state save and restore, and the reference's model-only
load (counterpart of ``sed_tpu.train.checkpoint``).

The format is the port's own: ``torch.save`` of ``{"model": state_dict,
"optimizer": ..., "scheduler": ..., "step": n}`` in
``checkpoints/iteration_{n}.pt``, loadable with ``weights_only=True``.  The
``model`` entry carries the reference's state-dict keys, so
``cli/infer.load_model`` reads the file as it is.  ``sed_tpu``'s flax
``.ckpt`` files and ``.ckpt.orbax`` directories are refused by name.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sed_tpu_torch.train.state import TrainState

SUFFIX = ".pt"
SED_TPU_SUFFIXES = (".ckpt", ".ckpt.orbax")


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
            f"{path} is a sed_tpu (flax) checkpoint; the port reads its own "
            f"iteration_{{n}}{SUFFIX} files (a converter is not ported yet, see ROADMAP.md)")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    template.model.load_state_dict(ckpt["model"], strict=True)
    if not model_only:
        template.optimizer.load_state_dict(ckpt["optimizer"])
        template.scheduler.load_state_dict(ckpt["scheduler"])
        template.step = int(ckpt["step"])
    return template


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

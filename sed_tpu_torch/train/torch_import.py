"""Import the reference's torch checkpoints into the port (counterpart of
``sed_tpu.train.torch_import``).

The reference saves ``torch.save({'iterations': N, 'model': state_dict,
'optimizer': ...})`` as ``checkpoints/iteration_N.pth``.  The port's models
carry the reference's state-dict keys, so no weight is mapped: each
``*_from_torch`` checks a reference state dict's key set and shapes against
the port model it is meant for and returns it as float32 CPU tensors.
:func:`import_torch_checkpoint` writes it as the port's own full-state
checkpoint, ``<out>/checkpoints/iteration_N.pt``, with a fresh optimizer
(the reference's own resume is model-only).

CLI: ``python -m sed_tpu_torch.cli.import_torch --pth iteration_60000.pth
--out imported_run --arch CnnAvgPooling``.
"""

from __future__ import annotations

import torch

from sed_tpu_torch.models.convert import FLAX_CONVERTERS


def check_state_dict(sd: dict, model: torch.nn.Module) -> dict:
    """``sd`` as a state dict of ``model``: the same keys, each of the same
    shape, floating tensors as float32 on the CPU.  A missing or unexpected
    key or a shape that differs raises ``ValueError`` naming them."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    shapes = [f"{k}: {tuple(sd[k].shape)} != {tuple(want[k].shape)}"
              for k in want if k in sd and tuple(sd[k].shape) != tuple(want[k].shape)]
    if missing or unexpected or shapes:
        raise ValueError(
            f"not a {type(model).__name__} state dict: missing {missing}, unexpected "
            f"{unexpected}, shapes {shapes}")
    out = {}
    for k, v in sd.items():
        t = torch.as_tensor(v).detach().cpu()
        out[k] = t.to(torch.float32) if t.is_floating_point() else t
    return out


# sed_tpu's names: the port's models carry the reference's keys, so each
# family's converter is the same check against the model it is given.
cnn_avg_pooling_from_torch = mobilenet_from_torch = m5_from_torch = check_state_dict


def load_reference_checkpoint(pth_path: str):
    """``(state_dict, iterations)`` of a reference ``.pth``: the training
    container ``{'iterations', 'model', 'optimizer'}`` or a bare state dict
    (iterations 0).  Read with ``weights_only=True``."""
    blob = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob:
        return blob["model"], int(blob.get("iterations", 0))
    return blob, 0


def import_torch_checkpoint(pth_path: str, model: torch.nn.Module, outputs_dir: str,
                            lr: float = 1e-4, device="cuda") -> str:
    """Convert a reference ``.pth`` into the port's
    ``<outputs_dir>/checkpoints/iteration_{N}.pt``, N the container's
    ``iterations``.

    ``model``: the matching port module (CnnAvgPooling, MobileNetV1 or M5).
    The weights load into it ``strict=True`` on ``device``; the optimizer
    and its schedule are fresh and the step is N.  Returns the path.
    """
    from sed_tpu_torch.inference import resolve_device
    from sed_tpu_torch.train.checkpoint import save_checkpoint
    from sed_tpu_torch.train.state import init_state

    name = type(model).__name__
    if name not in FLAX_CONVERTERS:
        raise ValueError(f"no torch converter for model {name!r}")
    sd, iterations = load_reference_checkpoint(pth_path)
    model = model.to(resolve_device(device))
    model.load_state_dict(check_state_dict(sd, model), strict=True)
    state = init_state(model, lr, device)
    state.step = iterations
    return save_checkpoint(state, outputs_dir, iterations)

"""Export checkpoints to the reference's torch format (counterpart of
``sed_tpu.train.torch_export``).

The output is the reference's container ``{'iterations': N, 'model':
state_dict, 'optimizer': {}}``, keyed as the reference models, so the model
loads into the reference with ``model.load_state_dict(checkpoint['model'])``.
The input is a port ``iteration_{n}.pt`` or a ``sed_tpu`` msgpack ``.ckpt``
(the file ``sed_tpu``'s exporter takes), or a reference ``.pth``.  As
``sed_tpu`` writes it, every BatchNorm's ``num_batches_tracked`` is 0 and
MobileNetV1's dead ``bn0`` (constructed, never called in forward) holds its
initial values; the optimizer state is dropped.

The ``*_to_torch`` functions take ``sed_tpu``'s flax trees, as ``sed_tpu``'s
do; they are ``models/convert.py``'s converters.

CLI: ``python -m sed_tpu_torch.cli.export_torch --ckpt
.../iteration_N.ckpt --arch CnnAvgPooling --out iteration_N.pth``.
"""

from __future__ import annotations

import torch

from sed_tpu_torch.models.convert import (FLAX_CONVERTERS, cnn_avg_pooling_state_dict,
                                          m5_state_dict, mobilenet_state_dict)

# sed_tpu's names for models/convert.py's converters.
cnn_avg_pooling_to_torch = cnn_avg_pooling_state_dict
mobilenet_to_torch = mobilenet_state_dict
m5_to_torch = m5_state_dict


def reference_state_dict(model: torch.nn.Module) -> dict:
    """``model``'s state dict on the CPU as ``sed_tpu`` exports it: every
    ``num_batches_tracked`` 0, MobileNetV1's dead ``bn0`` at its initial
    values (scale 1, bias 0, mean 0, var 1)."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0, dtype=torch.long)
    if type(model).__name__ == "MobileNetV1":
        for field, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            sd[f"bn0.{field}"] = torch.full_like(sd[f"bn0.{field}"], fill)
    return sd


def export_torch_checkpoint(ckpt_path: str, model: torch.nn.Module, pth_out: str,
                            device="cuda") -> str:
    """Write the weights of ``ckpt_path`` as a reference ``.pth`` at
    ``pth_out``; returns ``pth_out``.

    ``model``: the matching port module.  The weights load into it
    ``strict=True`` on ``device`` (so a file that does not fit the model
    fails here, not in the reference); the step rides as ``iterations``.
    """
    from sed_tpu_torch.inference import resolve_device
    from sed_tpu_torch.train.checkpoint import read_model_weights

    name = type(model).__name__
    if name not in FLAX_CONVERTERS:
        raise ValueError(f"no torch exporter for model {name!r}")
    sd, step = read_model_weights(ckpt_path, name)
    model = model.to(resolve_device(device))
    model.load_state_dict(sd, strict=True)
    torch.save({"iterations": step, "model": reference_state_dict(model),
                "optimizer": {}}, pth_out)
    return pth_out

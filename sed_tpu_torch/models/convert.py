"""``sed_tpu`` (flax) weights -> the port's state dicts.

Takes the JAX package's parameter trees as nested dicts of numpy arrays
(e.g. ``jax.tree.map(np.asarray, variables["params"])``) and returns a state
dict that loads into the port's module with ``strict=True``.  The keys and
the ``num_batches_tracked`` buffers are those of the reference checkpoints.
Every conversion is a transpose of the same float32 data, so it is exact.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _bn_entries(prefix: str, p: dict, s: dict) -> dict:
    """flax BatchNorm {scale, bias} + {mean, var} -> the five torch BN keys."""
    return {
        f"{prefix}.weight": _t(p["scale"]),
        f"{prefix}.bias": _t(p["bias"]),
        f"{prefix}.running_mean": _t(s["mean"]),
        f"{prefix}.running_var": _t(s["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def cnn_avg_pooling_state_dict(params, batch_stats) -> dict:
    """flax CnnAvgPooling tree -> CnnAvgPooling state dict.

    ``ConvBlock_{i}/Conv_{j}`` HWIO kernels -> ``conv_blocks.{i}.conv{j+1}``
    OIHW (transpose (3, 2, 0, 1)); ``BatchNorm_{j}`` -> ``bn{j+1}``;
    ``Dense_0`` (in, out) -> ``event_fc`` (out, in).
    """
    sd = {}
    n_blocks = sum(1 for k in params if k.startswith("ConvBlock_"))
    for i in range(n_blocks):
        blk, bs = params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"]
        for j in range(2):
            sd[f"conv_blocks.{i}.conv{j + 1}.weight"] = _t(
                np.transpose(np.asarray(blk[f"Conv_{j}"]["kernel"]), (3, 2, 0, 1)))
            sd.update(_bn_entries(f"conv_blocks.{i}.bn{j + 1}",
                                  blk[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"]))
    sd["event_fc.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["event_fc.bias"] = _t(params["Dense_0"]["bias"])
    return sd

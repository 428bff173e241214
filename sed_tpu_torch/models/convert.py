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


def _oihw(kernel) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


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
    OIHW; ``BatchNorm_{j}`` -> ``bn{j+1}``;
    ``Dense_0`` (in, out) -> ``event_fc`` (out, in).
    """
    sd = {}
    n_blocks = sum(1 for k in params if k.startswith("ConvBlock_"))
    for i in range(n_blocks):
        blk, bs = params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"]
        for j in range(2):
            sd[f"conv_blocks.{i}.conv{j + 1}.weight"] = _oihw(blk[f"Conv_{j}"]["kernel"])
            sd.update(_bn_entries(f"conv_blocks.{i}.bn{j + 1}",
                                  blk[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"]))
    sd["event_fc.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["event_fc.bias"] = _t(params["Dense_0"]["bias"])
    return sd


def mobilenet_state_dict(params, batch_stats) -> dict:
    """flax MobileNetV1 tree -> MobileNetV1 state dict.

    ``_ConvBN_0`` -> ``features.0.{0,2}``; ``_ConvDW_{i-1}`` ->
    ``features.{i}.{0,2,4,5}``; ``Dense_0`` -> ``fc1``, ``Dense_1`` ->
    ``fc_audioset``.  The reference's dead ``bn0`` has no flax counterpart
    and takes its initial values (scale 1, bias 0, mean 0, var 1).
    """
    sd = _bn_entries("bn0", {"scale": np.ones(64), "bias": np.zeros(64)},
                     {"mean": np.zeros(64), "var": np.ones(64)})
    p, s = params["_ConvBN_0"], batch_stats["_ConvBN_0"]
    sd["features.0.0.weight"] = _oihw(p["Conv_0"]["kernel"])
    sd.update(_bn_entries("features.0.2", p["BatchNorm_0"], s["BatchNorm_0"]))
    n_dw = sum(1 for k in params if k.startswith("_ConvDW_"))
    for i in range(1, n_dw + 1):
        p, s = params[f"_ConvDW_{i - 1}"], batch_stats[f"_ConvDW_{i - 1}"]
        sd[f"features.{i}.0.weight"] = _oihw(p["Conv_0"]["kernel"])
        sd.update(_bn_entries(f"features.{i}.2", p["BatchNorm_0"], s["BatchNorm_0"]))
        sd[f"features.{i}.4.weight"] = _oihw(p["Conv_1"]["kernel"])
        sd.update(_bn_entries(f"features.{i}.5", p["BatchNorm_1"], s["BatchNorm_1"]))
    for name, dense in (("fc1", "Dense_0"), ("fc_audioset", "Dense_1")):
        sd[f"{name}.weight"] = _t(np.asarray(params[dense]["kernel"]).T)
        sd[f"{name}.bias"] = _t(params[dense]["bias"])
    return sd


def m5_state_dict(params, batch_stats) -> dict:
    """flax M5 tree -> M5 state dict (either stem loads it).

    ``Conv_{j}`` (K, I, O) kernels -> ``conv_block{b}.{idx}.weight``
    (O, I, K) in call order, ``BatchNorm_{j}`` -> ``conv_block{b}.{idx+1}``,
    ``Dense_0`` -> ``fc``.
    """
    pairs = [("conv_block1", 0)]
    for b in range(2, 6):
        pairs += [(f"conv_block{b}", 0), (f"conv_block{b}", 3)]
    sd = {}
    for j, (block, idx) in enumerate(pairs):
        sd[f"{block}.{idx}.weight"] = _t(
            np.transpose(np.asarray(params[f"Conv_{j}"]["kernel"]), (2, 1, 0)))
        sd[f"{block}.{idx}.bias"] = _t(params[f"Conv_{j}"]["bias"])
        sd.update(_bn_entries(f"{block}.{idx + 1}", params[f"BatchNorm_{j}"],
                              batch_stats[f"BatchNorm_{j}"]))
    sd["fc.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["fc.bias"] = _t(params["Dense_0"]["bias"])
    return sd


# Model family -> its converter of flax (params, batch_stats) trees.
FLAX_CONVERTERS = {
    "CnnAvgPooling": cnn_avg_pooling_state_dict,
    "MobileNetV1": mobilenet_state_dict,
    "M5": m5_state_dict,
}

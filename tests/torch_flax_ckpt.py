"""A writer of ``sed_tpu``'s msgpack checkpoints from a port train state,
for hosts without flax and msgpack (the card's).

``sed_tpu`` saves ``flax.serialization.to_bytes`` of its train state
``{"step", "params", "batch_stats", "opt_state"}``, ``opt_state`` being
optax's ``({"count", "mu", "nu", "nu_max"}, {"count"})`` (AMSGrad, then the
schedule).  :func:`flax_state` builds that tree from a port
``TrainState`` (the inverse of ``models/convert.py``'s converters, the
moments through the same layout), and :func:`write_flax_checkpoint` writes
it in flax's msgpack subset: maps, strings, integers and numpy arrays as
extension type 1, ``(shape, dtype name, C-order bytes)``.  Arrays are
written float32, as ``sed_tpu`` keeps them; counts and the step int32.
``tests/test_torch_flax_resume.py`` proves that ``sed_tpu``'s
``load_checkpoint`` restores such a file to the state it came from.

This module imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

# torch Adam's moments -> optax AMSGrad's (sed_tpu.train.optim).
MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu", "max_exp_avg_sq": "nu_max"}


def msgpack(x) -> bytes:
    """``x`` (dicts with str keys, lists, str, bytes, int, numpy arrays) in
    the msgpack subset flax writes."""
    if isinstance(x, dict):
        return (b"\xdf" + len(x).to_bytes(4, "big")
                + b"".join(msgpack(k) + msgpack(v) for k, v in x.items()))
    if isinstance(x, str):
        return b"\xdb" + len(x.encode()).to_bytes(4, "big") + x.encode()
    if isinstance(x, list):
        return b"\xdd" + len(x).to_bytes(4, "big") + b"".join(msgpack(v) for v in x)
    if isinstance(x, bytes):
        return b"\xc6" + len(x).to_bytes(4, "big") + x
    if isinstance(x, int):
        return b"\xd3" + x.to_bytes(8, "big", signed=True)
    x = np.asarray(x)   # tobytes() is C order; ascontiguousarray would make a 0-d array 1-d
    payload = msgpack([[int(d) for d in x.shape], x.dtype.name, x.tobytes()])
    return b"\xc9" + len(payload).to_bytes(4, "big") + b"\x01" + payload


def _layout(arch: str, keys):
    """``[(port module, flax path, kind)]`` of ``arch``'s layers, kind one
    of 'conv2d', 'conv1d', 'dense', 'bn' (``models/convert.py``'s maps)."""
    if arch == "CnnAvgPooling":
        blocks = len({k.split(".")[1] for k in keys if k.startswith("conv_blocks.")})
        out = []
        for i in range(blocks):
            for j in range(2):
                out += [(f"conv_blocks.{i}.conv{j + 1}", (f"ConvBlock_{i}", f"Conv_{j}"),
                         "conv2d"),
                        (f"conv_blocks.{i}.bn{j + 1}", (f"ConvBlock_{i}", f"BatchNorm_{j}"),
                         "bn")]
        return out + [("event_fc", ("Dense_0",), "dense")]
    if arch == "MobileNetV1":
        dw = len({k.split(".")[1] for k in keys if k.startswith("features.")}) - 1
        out = [("features.0.0", ("_ConvBN_0", "Conv_0"), "conv2d"),
               ("features.0.2", ("_ConvBN_0", "BatchNorm_0"), "bn")]
        for i in range(1, dw + 1):
            block = f"_ConvDW_{i - 1}"
            out += [(f"features.{i}.0", (block, "Conv_0"), "conv2d"),
                    (f"features.{i}.2", (block, "BatchNorm_0"), "bn"),
                    (f"features.{i}.4", (block, "Conv_1"), "conv2d"),
                    (f"features.{i}.5", (block, "BatchNorm_1"), "bn")]
        return out + [("fc1", ("Dense_0",), "dense"), ("fc_audioset", ("Dense_1",), "dense")]
    if arch == "M5":
        pairs = [("conv_block1", 0)] + [(f"conv_block{b}", i) for b in range(2, 6)
                                        for i in (0, 3)]
        out = []
        for j, (block, idx) in enumerate(pairs):
            out += [(f"{block}.{idx}", (f"Conv_{j}",), "conv1d"),
                    (f"{block}.{idx + 1}", (f"BatchNorm_{j}",), "bn")]
        return out + [("fc", ("Dense_0",), "dense")]
    raise ValueError(f"unknown arch {arch!r}")


def _put(tree: dict, path, value: dict) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def flax_trees(arch: str, tensors: dict):
    """``(params, batch_stats)``: ``sed_tpu``'s trees of the port tensors
    ``{state-dict key: array}`` (weights, or one moment of them; the
    statistics when ``running_mean``/``running_var`` are among them).  Keys
    with no ``sed_tpu`` counterpart (MobileNetV1's ``bn0``) are left out;
    dtypes are kept."""
    tensors = {k: np.asarray(v) for k, v in tensors.items()}
    params, stats = {}, {}
    for prefix, path, kind in _layout(arch, tensors):
        weight, bias = tensors.get(f"{prefix}.weight"), tensors.get(f"{prefix}.bias")
        if kind == "bn":
            if weight is not None:
                _put(params, path, {"scale": weight, "bias": bias})
            if f"{prefix}.running_mean" in tensors:
                _put(stats, path, {"mean": tensors[f"{prefix}.running_mean"],
                                   "var": tensors[f"{prefix}.running_var"]})
            continue
        axes = {"conv2d": (2, 3, 1, 0), "conv1d": (2, 1, 0), "dense": (1, 0)}[kind]
        entry = {"kernel": np.ascontiguousarray(weight.transpose(axes))}
        if bias is not None:
            entry["bias"] = bias
        _put(params, path, entry)
    return params, stats


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def flax_state(state, arch: str) -> dict:
    """``sed_tpu``'s train-state tree of the port ``TrainState`` ``state``
    of model family ``arch``: weights and statistics, the AMSGrad moments
    and count (a parameter Adam has not stepped yet: zeros), the
    schedule's count (the ``LambdaLR``'s epoch) and the step."""
    model = state.model
    params, stats = flax_trees(arch, {k: v.detach().cpu().numpy()
                                      for k, v in model.state_dict().items()})
    opt = state.optimizer.state
    steps = {int(s["step"]) for s in opt.values()}
    if len(steps) > 1:
        raise ValueError(f"the parameters were stepped {sorted(steps)} times; sed_tpu "
                         f"keeps one count")
    amsgrad = {"count": np.asarray(steps.pop() if steps else 0, np.int32)}
    for name, key in MOMENTS.items():
        moment = {n: (opt[p][name] if p in opt else torch.zeros_like(p)).detach().cpu().numpy()
                  for n, p in model.named_parameters()}
        amsgrad[key] = _float32(flax_trees(arch, moment)[0])
    return {"step": np.asarray(state.step, np.int32), "params": _float32(params),
            "batch_stats": _float32(stats),
            "opt_state": {"0": amsgrad,
                          "1": {"count": np.asarray(state.scheduler.last_epoch, np.int32)}}}


def write_flax_checkpoint(path, state, arch: str) -> None:
    """Write ``state`` (a port ``TrainState`` of ``arch``) as ``sed_tpu``'s
    msgpack ``.ckpt`` at ``path``."""
    with open(path, "wb") as f:
        f.write(msgpack(flax_state(state, arch)))

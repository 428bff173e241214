"""Quantization-aware fine-tuning for the int8 serving path (counterpart of
``sed_tpu.models.qat``).

Fine-tune the trained float weights through the quantizer so they adapt to
int8 rounding; the export is the artifact ``models.quantize.quantize_cnn``
returns, scored by the unchanged ``quantized_cnn_forward``.  The scheme is
``sed_tpu``'s (CnnAvgPooling):

  * BatchNorm is frozen into per-channel affines from the running
    statistics; the affine's gain and bias are trainable.
  * Activation scales are calibrated once by the PTQ sweep
    (:func:`qat_init` delegates to ``quantize_cnn``) and then frozen.
  * Weights are fake-quantized each step with per-output-channel scales
    (absmax / 127, the scale outside the gradient) and a straight-through
    estimator on the round.

Two objectives: ``mode='distill'`` (MSE against the float teacher's
logits; needs no labels) and ``mode='bce'`` (``train.loss``'s weighted
BCE).  The trainable state is a dict of float32 tensors in the port's
layouts (OIHW conv weights, Linear's (out, in) dense weight); the static
state holds the frozen scales, the pools and ``interp``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.models.layers import interpolate
from sed_tpu_torch.models.quantize import _quantize_weight, quantize_cnn
from sed_tpu_torch.train.loss import weighted_bce_with_logits
from sed_tpu_torch.utils.precision import full_float32


def ste_fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 fake-quant: quantize-dequantize with STE rounding.

    The forward value is ``dequantize(quantize(x))`` as the serving path
    computes it; the gradient is identity where ``|x| <= 127 * scale`` and
    zero outside (the clip's own gradient).  The clip is ``jnp.clip``'s
    ``minimum(maximum(x, lo), hi)``, whose gradient splits in half where a
    value sits on a bound, as ``sed_tpu``'s does (``torch.clamp`` would pass
    all of it)."""
    q = x / scale
    qc = torch.minimum(torch.maximum(q, q.new_tensor(-127.0)), q.new_tensor(127.0))
    qr = qc + (torch.round(qc) - qc).detach()
    return qr * scale


def _weight_fake_quant(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel fake-quant with the scale outside the gradient.

    ``sed_tpu``'s fine-tune step runs under ``jax.jit``, where XLA turns the
    division of the per-channel absmax by the constant 127 into a product
    with 1 / 127 rounded to the weights' dtype.  That scale can sit one ulp
    from absmax / 127, which decides whether a channel's largest weight lies
    inside the clip (gradient 1), on it (1/2) or beyond it (0), so the step
    takes the same product: a Python scalar is rounded to the tensor's
    dtype before it multiplies."""
    absmax = w.detach().abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.clamp(absmax, min=1e-12) * (1.0 / 127.0)
    return ste_fake_quant(w, scale.view(-1, *[1] * (w.ndim - 1)))


def qat_init(model, calib_batches: Sequence) -> Tuple[Dict, Dict]:
    """(trainable, static) QAT state of a trained CnnAvgPooling.

    Calibration and the BatchNorm folding come from :func:`quantize_cnn`,
    so the scales and affines cannot part from the PTQ path; the float
    conv and dense weights are the trainable part."""
    q = quantize_cnn(model, calib_batches)
    blocks, act_scales = [], []
    for blk, layer in zip(model.conv_blocks, q["layers"]):
        qconvs = layer["convs"]
        blocks.append({
            "w": [conv.weight.detach().float().clone() for conv in (blk.conv1, blk.conv2)],
            "g": [c["bn_gain"] for c in qconvs],
            "b": [c["bn_bias"] for c in qconvs],
        })
        act_scales.extend(c["act_scale"] for c in qconvs)
    act_scales.append(q["dense"]["act_scale"])
    trainable = {"blocks": blocks,
                 "dense": {"w": model.event_fc.weight.detach().float().clone(),
                           "b": q["dense"]["bias"]}}
    static = {"act_scales": act_scales,
              "pools": tuple(layer["pool"] for layer in q["layers"]),
              "interp": q["interp"]}
    return trainable, static


def qat_export(trainable: Dict, static: Dict) -> Dict:
    """Quantize the fine-tuned weights into the serving artifact, in the
    exact structure :func:`quantize_cnn` returns."""
    layers, i = [], 0
    for blk, pool in zip(trainable["blocks"], static["pools"]):
        convs = []
        for c in range(2):
            qw, w_scale = _quantize_weight(blk["w"][c])
            convs.append({"qweight": qw, "w_scale": w_scale,
                          "act_scale": static["act_scales"][i],
                          "bn_gain": blk["g"][c].detach(), "bn_bias": blk["b"][c].detach()})
            i += 1
        layers.append({"convs": convs, "pool": pool})
    qd, d_scale = _quantize_weight(trainable["dense"]["w"])
    return {"layers": layers,
            "dense": {"qweight": qd, "w_scale": d_scale, "act_scale": static["act_scales"][i],
                      "bias": trainable["dense"]["b"].detach()},
            "interp": static["interp"]}


def qat_cnn_forward(trainable: Dict, static: Dict, x: torch.Tensor) -> torch.Tensor:
    """NCHW float input -> per-frame logits through the int8 lattice: every
    conv and the dense head contract fake-quantized activations against
    fake-quantized weights, so the values follow ``quantized_cnn_forward``
    up to float32 summation order."""
    i = 0
    for blk, pool in zip(trainable["blocks"], static["pools"]):
        for c in range(2):
            xq = ste_fake_quant(x, static["act_scales"][i])
            x = F.conv2d(xq, _weight_fake_quant(blk["w"][c]), padding=1)
            # jnp.maximum's ReLU: half the gradient at 0, as sed_tpu's.
            x = torch.maximum(x * blk["g"][c][:, None, None] + blk["b"][c][:, None, None],
                              x.new_tensor(0.0))
            i += 1
        if pool > 1:
            x = F.avg_pool2d(x, pool)
    x = x.mean(dim=3).transpose(1, 2)         # (batch, frames', channels)
    xq = ste_fake_quant(x, static["act_scales"][i])
    x = xq @ _weight_fake_quant(trainable["dense"]["w"]).t() + trainable["dense"]["b"]
    return interpolate(x, static["interp"])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def qat_finetune(trainable: Dict, static: Dict,
                 examples: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                 mode: str = "distill", steps: int = 200, lr: float = 3e-5,
                 pos_weight: float = 5.0, device="cuda") -> Dict:
    """Fine-tune the float weights through the quantizer on ``device``, in
    full float32 (or float64).

    ``examples``: (x, target) pairs of NCHW inputs and, per ``mode``, the
    float teacher's logits for x (``'distill'``: MSE on logits) or event
    matrices (``'bce'``: weighted BCE with the frame truncation).  Cycles
    through them for ``steps`` Adam steps (``torch.optim.Adam``, optax
    ``adam``'s defaults) and returns the fine-tuned trainable state on
    ``device``.  The state keeps its dtype, as ``sed_tpu``'s pytree does:
    float32 from :func:`qat_init` (TF32 off), or float64 when given so."""
    if mode not in ("distill", "bce"):
        raise ValueError(f"mode must be distill|bce, got {mode}")
    device = resolve_device(device)
    tr = _tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True), trainable)
    dtype = tr["dense"]["w"].dtype
    st = dict(static, act_scales=[torch.as_tensor(s).to(device) for s in static["act_scales"]])
    opt = torch.optim.Adam(_leaves(tr), lr=lr)
    batches = [(torch.as_tensor(np.asarray(x)).to(device, dtype),
                torch.as_tensor(np.asarray(t)).to(device, dtype)) for x, t in examples]
    with full_float32():
        for k in range(steps):
            x, target = batches[k % len(batches)]
            logits = qat_cnn_forward(tr, st, x)
            if mode == "distill":
                loss = torch.mean((logits - target) ** 2)
            else:
                loss = weighted_bce_with_logits(logits, target, pos_weight=pos_weight)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return _tree_map(lambda t: t.detach(), tr)

"""Post-training int8 quantization (counterpart of ``sed_tpu.models.quantize``).

The scheme is ``sed_tpu``'s:

  * conv and dense WEIGHTS: symmetric per-output-channel int8,
    scale = absmax / 127 over each output channel's fan-in;
  * ACTIVATIONS: symmetric per-tensor int8, scales calibrated with an
    absolute-max sweep of the float forward over sample batches;
  * the convolutions and dense heads run int8 x int8 -> int32
    (:mod:`sed_tpu_torch.ops.int8`: an im2col gather and ``torch._int_mm``
    on CUDA, an exact float64 product on the CPU); between them dequantize,
    inference-mode BatchNorm as a per-channel affine, ReLU, pooling and
    requantize run in float32, in ``sed_tpu``'s order:
    ``acc * (sa * w_scale)``, then ``* bn_gain + bn_bias``, ReLU, then
    ``clip(round(x / s_next))`` (both packages round half to even).

The ``quantize_*`` functions take the port model, whose weights and running
statistics are inside, in the place of ``sed_tpu``'s (model, params,
batch_stats), and calibration batches in the model's own input layout
(NCHW for the spectrogram CNNs, (batch, 1, samples) for M5).  They
calibrate in eval mode (the model is left there) and in full float32.  The
artifact is a dict with ``sed_tpu``'s keys and statics; its tensors live on
the model's device and its weights in the port's layouts (OIHW, M5's
(out, in, k), Linear's (out, in)); ``models.convert.qparams_from_flax``
carries ``sed_tpu``'s artifact across.  The forwards take what the float
models take, keep activations channels-last inside (NHWC, NWC) and run in
full float32 without autograd.

A lossy serving mode, not the parity path: the tests hold the int8 scores
to ``sed_tpu``'s fidelity classes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sed_tpu_torch.models.cnn import MOBILENET_STACK, MobileNetV1, num_pools
from sed_tpu_torch.models.layers import BN_EPS, interpolate
from sed_tpu_torch.models.m5 import M5, S2D_BLOCK, _s2d_geometry, s2d_conv1_kernel
from sed_tpu_torch.ops.int8 import int8_conv1d_nwc, int8_conv2d_nhwc, int8_matmul
from sed_tpu_torch.utils.precision import full_float32


def _per_channel_scale(w: torch.Tensor) -> torch.Tensor:
    """absmax / 127 over all but the first (output-channel) axis; zero-safe."""
    absmax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    return torch.clamp(absmax, min=1e-12) / 127.0


def _quantize_weight(w: torch.Tensor):
    """Port-layout float weight -> (int8 weight, per-output-channel scale)."""
    w = w.detach().float()
    scale = _per_channel_scale(w)
    q = torch.clamp(torch.round(w / scale.view(-1, *[1] * (w.ndim - 1))), -127, 127)
    return q.to(torch.int8), scale


def _quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _bn_affine(bn) -> tuple:
    """Inference-mode BatchNorm as y = g*x + b (running stats folded)."""
    inv = bn.weight.detach() / torch.sqrt(bn.running_var + BN_EPS)
    return inv, bn.bias.detach() - bn.running_mean * inv


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _absmax_sweep(model, calib_batches, taps) -> np.ndarray:
    """The largest |value| of each tapped tensor over the float forward of
    every calibration batch.  ``taps``: ``(module, "input" | "output")``
    pairs, or ``None`` for the batch itself.  Runs in eval mode (the model
    is left there) and in full float32."""
    absmax = np.zeros(len(taps))
    seen: Dict[int, float] = {}

    def record(i, x):
        seen[i] = float(x.abs().max())

    hooks = []
    for i, tap in enumerate(taps):
        if tap is None:
            continue
        module, where = tap
        if where == "input":
            hooks.append(module.register_forward_pre_hook(
                lambda m, args, i=i: record(i, args[0])))
        else:
            hooks.append(module.register_forward_hook(
                lambda m, args, out, i=i: record(i, out)))
    device = _model_device(model)
    model.eval()
    try:
        with torch.no_grad(), full_float32():
            for cb in calib_batches:
                x = torch.as_tensor(np.asarray(cb, np.float32) if not torch.is_tensor(cb)
                                    else cb).to(device, torch.float32)
                seen.clear()
                for i, tap in enumerate(taps):
                    if tap is None:
                        record(i, x)
                model(x)
                for i, v in seen.items():
                    absmax[i] = max(absmax[i], v)
    finally:
        for h in hooks:
            h.remove()
    return absmax


def _act_scales(absmax: np.ndarray, device) -> List[torch.Tensor]:
    """float32(max(absmax, 1e-12) / 127), the division in float64 as
    ``sed_tpu`` does it in numpy; 0-d tensors on ``device``."""
    scales = np.maximum(absmax, 1e-12) / 127.0
    return [torch.tensor(np.float32(s), device=device) for s in scales]


def _qdense(linear, act_scale) -> Dict[str, Any]:
    qd, d_scale = _quantize_weight(linear.weight)
    return {"qweight": qd, "w_scale": d_scale, "act_scale": act_scale,
            "bias": linear.bias.detach().float().clone()}


def _qdot(d: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """int8 dense head: (..., in) float -> (..., out) float."""
    sa = d["act_scale"]
    xq = _quantize_act(x, sa)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), d["qweight"].t())
    acc = acc.reshape(*xq.shape[:-1], acc.shape[-1])
    return acc.float() * (sa * d["w_scale"]) + d["bias"]


def _epilogue(acc: torch.Tensor, sa, scale, gain, bias) -> torch.Tensor:
    """Dequantize, BatchNorm affine, ReLU (``sed_tpu``'s order)."""
    x = acc.float() * (sa * scale)
    return torch.relu(x * gain + bias)


def _avg_pool_nhwc(x: torch.Tensor, pool: int) -> torch.Tensor:
    """VALID average pool of an NHWC tensor by ``pool`` (the float model's
    ``F.avg_pool2d``, on the channels-last view)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), pool).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# CnnAvgPooling
# ---------------------------------------------------------------------------


def quantize_cnn(model, calib_batches: Sequence) -> Dict[str, Any]:
    """The int8 serving artifact of a trained CnnAvgPooling, calibrated on
    ``calib_batches`` (NCHW sample inputs, arrays or tensors)."""
    cfg = model.model_config
    pairs = [p for blk in model.conv_blocks for p in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2))]
    absmax = _absmax_sweep(model, calib_batches,
                           [(conv, "input") for conv, _ in pairs] + [(model.event_fc, "input")])
    act = _act_scales(absmax, _model_device(model))
    layers, i = [], 0
    for b, (_, pool) in enumerate(cfg):
        convs = []
        for conv, bn in pairs[2 * b: 2 * b + 2]:
            qw, w_scale = _quantize_weight(conv.weight)
            g, bias = _bn_affine(bn)
            convs.append({"qweight": qw, "w_scale": w_scale, "act_scale": act[i],
                          "bn_gain": g.float(), "bn_bias": bias.float()})
            i += 1
        layers.append({"convs": convs, "pool": pool})
    return {"layers": layers, "dense": _qdense(model.event_fc, act[i]),
            "interp": 2 ** num_pools(cfg)}


@torch.no_grad()
@full_float32()
def quantized_cnn_forward(qparams, x: torch.Tensor) -> torch.Tensor:
    """int8 CnnAvgPooling forward: NCHW float input -> (batch, frames,
    classes) logits, every conv and the dense head on the int8 path."""
    x = x.permute(0, 2, 3, 1)                 # NHWC
    for layer in qparams["layers"]:
        for conv in layer["convs"]:
            sa = conv["act_scale"]
            acc = int8_conv2d_nhwc(_quantize_act(x, sa), conv["qweight"], pad=1)
            x = _epilogue(acc, sa, conv["w_scale"], conv["bn_gain"], conv["bn_bias"])
        if layer["pool"] > 1:
            x = _avg_pool_nhwc(x, layer["pool"])
    x = _qdot(qparams["dense"], x.mean(dim=2))   # mel-axis mean -> (batch, frames', feat)
    return interpolate(x, qparams["interp"])


def quantized_scores(qparams, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid confidences from the int8 CnnAvgPooling forward."""
    return torch.sigmoid(quantized_cnn_forward(qparams, x))


def quantized_serving_scores(qparams, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid confidences from either spectrogram family's artifact, the
    family read from the artifact: MobileNetV1's carries the ``dense1``
    head (its forward emits sigmoid), CnnAvgPooling's the single ``dense``
    (logits; the sigmoid is applied here).  The one dispatch the streaming
    stack uses."""
    if "dense1" in qparams:
        return quantized_mobilenet_forward(qparams, x)
    return torch.sigmoid(quantized_cnn_forward(qparams, x))


# ---------------------------------------------------------------------------
# MobileNetV1
# ---------------------------------------------------------------------------


def quantize_mobilenet(model, calib_batches) -> Dict[str, Any]:
    """int8 artifact of a trained MobileNetV1 (either ``emit`` view).

    Only the pointwise 1x1 convolutions and both dense heads are int8; the
    first conv-BN stage and the depthwise 3x3s stay float32 (cuDNN), as in
    ``sed_tpu``."""
    blocks = list(model.features)
    points = [blk for (kind, _, _), blk in zip(MOBILENET_STACK, blocks) if kind == "dw"]
    absmax = _absmax_sweep(model, calib_batches,
                           [(blk[4], "input") for blk in points]
                           + [(model.fc1, "input"), (model.fc_audioset, "input")])
    act = _act_scales(absmax, _model_device(model))
    out, pi = [], 0
    for (kind, _, stride), blk in zip(MOBILENET_STACK, blocks):
        g0, bias0 = _bn_affine(blk[2])
        entry = {"kind": kind, "stride": stride,
                 "dw_kernel": blk[0].weight.detach().float().clone(),
                 "bn0_gain": g0.float(), "bn0_bias": bias0.float()}
        if kind == "dw":
            qw, w_scale = _quantize_weight(blk[4].weight)
            g1, bias1 = _bn_affine(blk[5])
            entry.update(qweight=qw, w_scale=w_scale, act_scale=act[pi],
                         bn1_gain=g1.float(), bn1_bias=bias1.float())
            pi += 1
        out.append(entry)
    return {"blocks": out, "dense0": _qdense(model.fc1, act[pi]),
            "dense1": _qdense(model.fc_audioset, act[pi + 1]), "interp": 2 ** 3}


@torch.no_grad()
@full_float32()
def quantized_mobilenet_forward(qparams, x: torch.Tensor) -> torch.Tensor:
    """int8 MobileNetV1 forward: NCHW float -> (batch, frames, classes)
    sigmoid confidences (the reference's forward emits sigmoid)."""
    x = x.permute(0, 2, 3, 1)                 # NHWC
    for blk in qparams["blocks"]:
        w = blk["dw_kernel"]
        groups = 1 if blk["kind"] == "bn" else x.shape[-1]
        # The float conv on the channels-last view, back to NHWC.
        x = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=groups).permute(0, 2, 3, 1)
        if blk["stride"] > 1:
            x = _avg_pool_nhwc(x, blk["stride"])
        x = torch.relu(x * blk["bn0_gain"] + blk["bn0_bias"])
        if blk["kind"] == "dw":
            sa = blk["act_scale"]
            acc = int8_conv2d_nhwc(_quantize_act(x, sa), blk["qweight"], pad=0)
            x = _epilogue(acc, sa, blk["w_scale"], blk["bn1_gain"], blk["bn1_bias"])
    x = torch.relu(_qdot(qparams["dense0"], x.mean(dim=2)))
    x = torch.sigmoid(_qdot(qparams["dense1"], x))
    return interpolate(x, qparams["interp"])


# ---------------------------------------------------------------------------
# M5
# ---------------------------------------------------------------------------

# (stride, padding, max-pool after) per conv, as M5.forward runs them.
_M5_SPEC = [(4, 39, 4), (1, 1, None), (1, 1, 4), (1, 1, None), (1, 1, 4),
            (1, 1, None), (1, 1, 4), (1, 1, None), (1, 1, None)]


def _m5_conv_bns(model):
    """M5's nine (Conv1d, BatchNorm1d) pairs in call order."""
    pairs = [(model.conv_block1[0], model.conv_block1[1])]
    for block in (model.conv_block2, model.conv_block3, model.conv_block4, model.conv_block5):
        pairs += [(block[0], block[1]), (block[3], block[4])]
    return pairs


def quantize_m5(model, calib_batches: Sequence) -> Dict[str, Any]:
    """int8 artifact of a trained M5, calibrated on (batch, 1, samples)
    batches.  The conv biases fold into the BatchNorm affine,
    BN(conv + b) = g*conv + (g*b + c); the dense head's scale is taken on
    the last conv's per-timestep activations, before the time mean (a
    post-mean absmax would clip loud transients)."""
    pairs = _m5_conv_bns(model)
    # The stem's input is the batch itself (the space-to-depth stem never
    # calls its Conv1d module).
    absmax = _absmax_sweep(model, calib_batches,
                           [None] + [(conv, "input") for conv, _ in pairs[1:]]
                           + [(model.conv_block5, "output")])
    act = _act_scales(absmax, _model_device(model))
    convs = []
    for i, ((stride, pad, pool), (conv, bn)) in enumerate(zip(_M5_SPEC, pairs)):
        assert (conv.stride[0], conv.padding[0]) == (stride, pad)
        qw, w_scale = _quantize_weight(conv.weight)
        g, bias = _bn_affine(bn)
        convs.append({"qweight": qw, "w_scale": w_scale, "act_scale": act[i],
                      "bn_gain": g.float(),
                      "bn_bias": (g * conv.bias.detach() + bias).float(),
                      "stride": stride, "pad": pad, "pool": pool})
    return {"convs": convs, "dense": _qdense(model.fc, act[len(_M5_SPEC)])}


def _s2d_stem_int8(xq: torch.Tensor, qweight: torch.Tensor, stride: int,
                   pad: int) -> torch.Tensor:
    """The stem through the space-to-depth tiling of ``models/m5.s2d_conv1``
    on int8: (batch, samples, 1) -> (batch, n_out, C) int32, equal to the
    direct conv (integer sums do not depend on their order, and the
    scattered weight entries are int8 zeros)."""
    B, n, _ = xq.shape
    C, _, K = qweight.shape
    phases, L, kw = _s2d_geometry(K, stride, pad, S2D_BLOCK)
    n_out = (n + 2 * pad - K) // stride + 1
    n_out_blocks = -(-n_out // phases)
    padded = S2D_BLOCK * (n_out_blocks + kw - 1)
    left = S2D_BLOCK * L
    xb = xq.new_zeros((B, padded))
    xb[:, left:left + n] = xq[..., 0]
    y = int8_conv1d_nwc(xb.view(B, padded // S2D_BLOCK, S2D_BLOCK),
                        s2d_conv1_kernel(qweight, stride=stride, pad=pad), 1, 0)
    # (B, blocks, phases * C) -> (B, blocks * phases, C): time = phases * j + p.
    return y.reshape(B, n_out_blocks * phases, C)[:, :n_out]


@torch.no_grad()
@full_float32()
def quantized_m5_forward(qparams, x: torch.Tensor, *, conv1_impl: str = "direct") -> torch.Tensor:
    """int8 M5 forward: (batch, 1, samples) float -> (batch, classes) logits.

    Every tensor between the layers is int8: max-pool commutes with the
    monotonic quantize, so it runs on int8 (over the VALID prefix, as
    ``sed_tpu``'s ``reduce_window`` with init -128).  The time mean is an
    int32 sum, then a float dense.  ``conv1_impl='s2d'`` takes the stem
    through the space-to-depth tiling, equal to ``'direct'`` (the
    default)."""
    if conv1_impl not in ("direct", "s2d"):
        raise ValueError(f"conv1_impl must be direct|s2d, got {conv1_impl!r}")
    convs = qparams["convs"]
    xq = _quantize_act(x.permute(0, 2, 1), convs[0]["act_scale"])   # NWC
    for i, conv in enumerate(convs):
        sa = conv["act_scale"]
        if i == 0 and conv1_impl == "s2d":
            acc = _s2d_stem_int8(xq, conv["qweight"], conv["stride"], conv["pad"])
        else:
            acc = int8_conv1d_nwc(xq, conv["qweight"], conv["stride"], conv["pad"])
        y = _epilogue(acc, sa, conv["w_scale"], conv["bn_gain"], conv["bn_bias"])
        s_next = convs[i + 1]["act_scale"] if i + 1 < len(convs) else qparams["dense"]["act_scale"]
        xq = _quantize_act(y, s_next)
        p = conv["pool"]
        if p:
            b, t, c = xq.shape
            xq = xq[:, : t - t % p].reshape(b, t // p, p, c).amax(dim=2)
    d = qparams["dense"]
    t = xq.shape[1]
    summed = xq.to(torch.int32).sum(dim=1)
    acc = (summed.to(torch.float32) / t) @ d["qweight"].float().t()
    return acc * (d["act_scale"] * d["w_scale"]) + d["bias"]


def quantize_model(model, calib_batches: Sequence) -> Tuple[Dict[str, Any], Callable]:
    """(artifact, forward) of a trained model of any family, calibrated on
    ``calib_batches`` in the model's own input layout: ``quantize_m5`` and
    ``quantized_m5_forward`` (logits) for M5, ``quantize_mobilenet`` and
    ``quantized_mobilenet_forward`` (scores, whatever the model's ``emit``)
    for MobileNetV1, ``quantize_cnn`` and ``quantized_cnn_forward``
    (logits) for CnnAvgPooling."""
    if isinstance(model, M5):
        return quantize_m5(model, calib_batches), quantized_m5_forward
    if isinstance(model, MobileNetV1):
        return quantize_mobilenet(model, calib_batches), quantized_mobilenet_forward
    return quantize_cnn(model, calib_batches), quantized_cnn_forward


def qparams_to(qparams, device):
    """The artifact with every tensor moved to ``device`` (statics kept)."""
    if torch.is_tensor(qparams):
        return qparams.to(device)
    if isinstance(qparams, dict):
        return {k: qparams_to(v, device) for k, v in qparams.items()}
    if isinstance(qparams, list):
        return [qparams_to(v, device) for v in qparams]
    return qparams

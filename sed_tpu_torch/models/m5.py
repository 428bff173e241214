"""M5: the 1-D CNN over raw waveform frames (counterpart of
``sed_tpu.models.m5``).

NCW input (batch, 1, 31680), one logit per frame and class out; the caller
applies the sigmoid.  The state-dict keys are the reference's,
``conv_block{b}.{idx}.*`` and ``fc.*``, which is what
``sed_tpu.train.torch_export.m5_to_torch`` emits.

Two stems compute the first layer, Conv1d(1 -> 64, k=79, stride 4, pad 39),
from the same weights, so one state dict loads into either:

  * direct (the default): the Conv1d itself;
  * space-to-depth (``conv1_s2d=True``): the waveform viewed as (B, N/16, 16)
    blocks of 16 samples, and a Conv1d of k=7 over those 16 channels whose
    256 outputs are 4 stride phases x 64 channels (:func:`s2d_conv1`).  The
    same products, another float32 summation order.

``sed_tpu`` picks the space-to-depth stem by default in float32, from a
measurement on a TPU (it fills the MXU's lanes).  The port's default is the
direct stem; ``chip_smoke.py`` times both on the card.

``dtype=torch.bfloat16`` is ``sed_tpu``'s bf16 serving tier, as for the
spectrogram CNNs (``models.cnn``): bfloat16 compute, float32 parameters,
statistics and logits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sed_tpu_torch.models.layers import (BN_EPS, BatchNorm1d, Conv1d, Linear, reduced_like,
                                         init_batch_norm_, kaiming_uniform_)

# Waveform samples per block for the space-to-depth stem.
S2D_BLOCK = 16


def _s2d_geometry(K: int, stride: int, pad: int, block: int):
    """(phases, left-context blocks L, kernel width in blocks kw)."""
    assert block % stride == 0
    phases = block // stride
    L = -(-pad // block)
    kw = L + -(-(stride * (phases - 1) - pad + K) // block)
    return phases, L, kw


def s2d_conv1_kernel(w: torch.Tensor, *, stride: int = 4, pad: int = 39,
                     block: int = S2D_BLOCK) -> torch.Tensor:
    """Scatter a Conv1d stem weight (C, 1, K) into its space-to-depth form,
    the Conv1d weight (phases * C, block, kw), phases = block // stride.

    Output channel ``p * C + c`` of the blocked conv is stride phase ``p`` of
    original channel ``c``; positions the K taps do not cover are zero.  The
    values are ``sed_tpu``'s (kw, block, phases * C) kernel, transposed.
    """
    C, cin, K = w.shape
    assert cin == 1, "the space-to-depth stem needs a 1-channel input"
    phases, L, kw = _s2d_geometry(K, stride, pad, block)
    flat = w.new_zeros((kw * block, phases, C))
    base = block * L - pad
    taps = w[:, 0, :].T  # (K, C)
    for p in range(phases):
        flat[base + stride * p: base + stride * p + K, p, :] = taps
    return flat.reshape(kw, block, phases * C).permute(2, 1, 0)


def s2d_conv1(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
              stride: int = 4, pad: int = 39, block: int = S2D_BLOCK) -> torch.Tensor:
    """Space-to-depth evaluation of ``Conv1d(1 -> C, K, stride, pad)``.

    x: (B, 1, n); w: (C, 1, K); returns (B, C, n_out), the values of
    ``F.conv1d(x, w, b, stride, pad)`` up to float32 summation order.
    """
    B, cin, n = x.shape
    C, _, K = w.shape
    assert cin == 1
    phases, L, kw = _s2d_geometry(K, stride, pad, block)
    n_out = (n + 2 * pad - K) // stride + 1
    left = block * L
    n_out_blocks = -(-n_out // phases)
    padded = block * (n_out_blocks + kw - 1)
    xb = F.pad(x[:, 0], (left, padded - left - n))
    xb = xb.view(B, padded // block, block).transpose(1, 2)  # (B, block, blocks)
    y = F.conv1d(xb, s2d_conv1_kernel(w, stride=stride, pad=pad, block=block))
    # (B, phases * C, blocks) -> (B, C, blocks * phases): time = phases * j + p.
    y = y.view(B, phases, C, n_out_blocks).permute(0, 2, 3, 1)
    y = y.reshape(B, C, n_out_blocks * phases)[:, :, :n_out]
    return y if b is None else y + b[:, None]


def _conv_bn_relu(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                  pad: int = 1):
    return [Conv1d(in_ch, out_ch, kernel, stride=stride, padding=pad),
            BatchNorm1d(out_ch, eps=BN_EPS), nn.ReLU()]


class M5(nn.Module):
    """Conv1d(k=79, s=4) + 4 conv stages with max-pool 4 + global-mean head.

    Built on the meta device and initialized with ``generator``; created on
    the CPU, moved with ``.to(device)``.
    """

    def __init__(self, classes_num: int, conv1_s2d: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1_s2d = conv1_s2d
        self.dtype = dtype
        with torch.device("meta"):
            self.conv_block1 = nn.Sequential(*_conv_bn_relu(1, 64, 79, 4, 39),
                                             nn.MaxPool1d(4))
            self.conv_block2 = nn.Sequential(*_conv_bn_relu(64, 64), *_conv_bn_relu(64, 64),
                                             nn.MaxPool1d(4))
            self.conv_block3 = nn.Sequential(*_conv_bn_relu(64, 64), *_conv_bn_relu(64, 64),
                                             nn.MaxPool1d(4))
            self.conv_block4 = nn.Sequential(*_conv_bn_relu(64, 128),
                                             *_conv_bn_relu(128, 128), nn.MaxPool1d(4))
            self.conv_block5 = nn.Sequential(*_conv_bn_relu(128, 256),
                                             *_conv_bn_relu(256, 256))
            self.fc = Linear(256, classes_num, bias=True)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                kaiming_uniform_(module.weight, generator)
                with torch.no_grad():
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm1d):
                init_batch_norm_(module)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        conv, bn, relu, pool = self.conv_block1
        if self.conv1_s2d:
            x = s2d_conv1(x, reduced_like(conv.weight, x), reduced_like(conv.bias, x),
                          stride=conv.stride[0], pad=conv.padding[0])
        else:
            x = conv(x)
        x = pool(relu(bn(x)))
        for block in (self.conv_block2, self.conv_block3, self.conv_block4,
                      self.conv_block5):
            x = block(x)
        logits = self.fc(x.mean(dim=2))   # global mean over time -> (batch, classes)
        return logits if self.dtype is None else logits.float()

"""The spectrogram CNNs: CnnAvgPooling (the flagship) and MobileNetV1
(counterpart of ``sed_tpu.models.cnn``).

NCHW input (batch, channels, frames, mel_bins), the featurizer's own output
layout.  CnnAvgPooling emits per-frame logits (the caller applies the
sigmoid); MobileNetV1 emits sigmoid scores by default, as the reference
does.  ``dtype=torch.bfloat16`` is ``sed_tpu``'s bf16 serving tier (its
``dtype``): the forward computes in bfloat16 (``models.layers``), the
parameters and BatchNorm statistics stay float32, and the output returns
as float32; the default ``None`` computes in the input's dtype.  The state-dict keys are the reference's, which is what
``sed_tpu.train.torch_export`` emits, so exported checkpoints load with
``strict=True``:

  * CnnAvgPooling: ``conv_blocks.{i}.conv{1,2}.weight``,
    ``conv_blocks.{i}.bn{1,2}.*``, ``event_fc.*``;
  * MobileNetV1: ``features.{i}.{0,2,4,5}.*``, ``fc1.*``, ``fc_audioset.*``
    and the reference's ``bn0.*``, a BatchNorm2d(64) that the forward never
    calls.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sed_tpu_torch.models.layers import (BN_EPS, BatchNorm2d, Conv2d, ConvBlock, Linear,
                                         init_batch_norm_, interpolate, kaiming_uniform_)

# Reference DEFAULT_CHANNEL_AND_POOL.
DEFAULT_CHANNEL_AND_POOL: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 2), (512, 1))
# Config the training and inference CLIs instantiate.
TRAIN_CHANNEL_AND_POOL: Tuple[Tuple[int, int], ...] = ((32, 2), (64, 2), (128, 2), (128, 1))

# MobileNetV1 block stack: one conv-bn stage, then depthwise-separable
# stages, as ("bn"|"dw", out_channels, stride).
MOBILENET_STACK: Tuple[Tuple[str, int, int], ...] = (
    ("bn", 32, 2), ("dw", 64, 1), ("dw", 128, 2), ("dw", 128, 1),
    ("dw", 256, 2), ("dw", 256, 1), ("dw", 512, 1), ("dw", 512, 1),
    ("dw", 512, 1), ("dw", 512, 1), ("dw", 512, 1), ("dw", 1024, 1),
    ("dw", 1024, 1),
)


def mobilenet_receptive_field() -> int:
    """Time receptive field (frames) of the MobileNetV1 stack: per block one
    k=3 conv (+2 frames at the current stride) followed by an avg-pool of
    k = stride (the pointwise 1x1 conv of a ``dw`` block adds nothing)."""
    rf, jump = 1, 1
    for _, _, stride in MOBILENET_STACK:
        rf += 2 * jump              # the 3x3 (depthwise) conv
        rf += (stride - 1) * jump   # avg-pool k=stride
        jump *= stride
    return rf


def num_pools(model_config: Sequence[Tuple[int, int]]) -> int:
    """Count of 2x time-pooling stages, reproducing the reference counter.

    The reference starts its counter at 1 whatever the first stage pools
    (a latent bug that is right for every shipped config, whose first stage
    pools by 2), then adds 1 per later stage that pools by 2.
    """
    return 1 + sum(1 for (_, pool) in list(model_config)[1:] if pool == 2)


class CnnAvgPooling(nn.Module):
    """ConvBlocks -> mean over mel -> per-frame Linear -> upsample by
    2**num_pools to the input frame rate.

    Built on the meta device and then initialized with ``generator``, so
    construction draws nothing from the global random state.  The module is
    created on the CPU; move it with ``.to(device)``.
    """

    def __init__(self, classes_num: int,
                 model_config: Sequence[Tuple[int, int]] = DEFAULT_CHANNEL_AND_POOL,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model_config = tuple(tuple(c) for c in model_config)
        self.dtype = dtype
        with torch.device("meta"):
            blocks, in_ch = [], 1
            for out_ch, pool in self.model_config:
                blocks.append(ConvBlock(in_ch, out_ch, pool))
                in_ch = out_ch
            self.conv_blocks = nn.ModuleList(blocks)
            self.event_fc = Linear(in_ch, classes_num, bias=True)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for block in self.conv_blocks:
            block.reset_parameters(generator)
        kaiming_uniform_(self.event_fc.weight, generator)
        with torch.no_grad():
            self.event_fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        for block in self.conv_blocks:
            x = block(x)
        x = x.mean(dim=3).transpose(1, 2)   # (batch, frames', channels)
        logits = self.event_fc(x)           # (batch, frames', classes)
        logits = interpolate(logits, 2 ** num_pools(self.model_config))
        return logits if self.dtype is None else logits.float()


def _pool(stride: int) -> nn.Module:
    """Avg-pool over (frames, mel) by ``stride``, flooring odd sizes as
    flax's VALID ``avg_pool`` does; a parameter-free stand-in at stride 1
    keeps the reference's Sequential indices."""
    return nn.AvgPool2d(stride) if stride > 1 else nn.Identity()


def _conv_bn(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    """conv3x3 -> avg-pool(stride) -> BN -> ReLU."""
    return nn.Sequential(Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
                         _pool(stride), BatchNorm2d(out_ch, eps=BN_EPS),
                         nn.ReLU())


def _conv_dw(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    """Depthwise conv3x3 -> avg-pool(stride) -> BN -> ReLU -> pointwise 1x1
    -> BN -> ReLU."""
    return nn.Sequential(
        Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch, bias=False),
        _pool(stride), BatchNorm2d(in_ch, eps=BN_EPS), nn.ReLU(),
        Conv2d(in_ch, out_ch, 1, bias=False), BatchNorm2d(out_ch, eps=BN_EPS),
        nn.ReLU())


class MobileNetV1(nn.Module):
    """Depthwise-separable 2-D CNN -> mean over mel -> fc1 + ReLU ->
    fc_audioset -> (sigmoid) -> upsample by 8 to the input frame rate.

    ``emit='scores'`` (the reference's forward) applies the sigmoid before
    the upsampling; ``emit='logits'`` skips it, for a loss that takes
    logits.  The parameters are the same either way.  Built on the meta
    device and initialized with ``generator``, as :class:`CnnAvgPooling`.
    """

    def __init__(self, classes_num: int, emit: str = "scores",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if emit not in ("scores", "logits"):
            raise ValueError(f"emit must be 'scores' or 'logits', got {emit!r}")
        self.emit = emit
        self.dtype = dtype
        with torch.device("meta"):
            self.bn0 = BatchNorm2d(64, eps=BN_EPS)   # the reference's; never called
            blocks, in_ch = [], 1
            for kind, out_ch, stride in MOBILENET_STACK:
                blocks.append((_conv_bn if kind == "bn" else _conv_dw)(in_ch, out_ch, stride))
                in_ch = out_ch
            self.features = nn.Sequential(*blocks)
            self.fc1 = Linear(in_ch, 1024, bias=True)
            self.fc_audioset = Linear(1024, classes_num, bias=True)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                kaiming_uniform_(module.weight, generator)
                if module.bias is not None:
                    with torch.no_grad():
                        module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                init_batch_norm_(module)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.features(x)
        x = x.mean(dim=3).transpose(1, 2)   # (batch, frames', 1024)
        x = self.fc_audioset(torch.relu(self.fc1(x)))
        if self.dtype is not None:
            x = x.float()
        if self.emit == "scores":
            x = torch.sigmoid(x)
        return interpolate(x, 2 ** 3)

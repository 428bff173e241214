"""CnnAvgPooling, the flagship spectrogram CNN (counterpart of
``sed_tpu.models.cnn``).

NCHW input (batch, channels, frames, mel_bins) — the featurizer's own output
layout — and per-frame logits out; the caller applies the sigmoid.  The
state-dict keys are the reference's (``conv_blocks.{i}.conv{1,2}.weight``,
``conv_blocks.{i}.bn{1,2}.*``, ``event_fc.*``), which is what
``sed_tpu.train.torch_export.cnn_avg_pooling_to_torch`` emits, so exported
checkpoints load with ``strict=True``.  MobileNetV1 is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sed_tpu_torch.models.layers import ConvBlock, interpolate, kaiming_uniform_

# Reference DEFAULT_CHANNEL_AND_POOL.
DEFAULT_CHANNEL_AND_POOL: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 2), (512, 1))
# Config the training and inference CLIs instantiate.
TRAIN_CHANNEL_AND_POOL: Tuple[Tuple[int, int], ...] = ((32, 2), (64, 2), (128, 2), (128, 1))


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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model_config = tuple(tuple(c) for c in model_config)
        with torch.device("meta"):
            blocks, in_ch = [], 1
            for out_ch, pool in self.model_config:
                blocks.append(ConvBlock(in_ch, out_ch, pool))
                in_ch = out_ch
            self.conv_blocks = nn.ModuleList(blocks)
            self.event_fc = nn.Linear(in_ch, classes_num, bias=True)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for block in self.conv_blocks:
            block.reset_parameters(generator)
        kaiming_uniform_(self.event_fc.weight, generator)
        with torch.no_grad():
            self.event_fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.conv_blocks:
            x = block(x)
        x = x.mean(dim=3).transpose(1, 2)   # (batch, frames', channels)
        logits = self.event_fc(x)           # (batch, frames', classes)
        return interpolate(logits, 2 ** num_pools(self.model_config))

"""Time-axis geometry of the fully convolutional models (counterpart of
``sed_tpu.parallel.time_shard``).

Only :func:`receptive_field` is ported so far: the streaming detectors use
it to check that their halo covers half the model's receptive field.  The
windowed exact forward over long recordings (``windowed_forward``) comes
with the parallelism slice (ROADMAP.md, slice G).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def receptive_field(model_config: Sequence[Tuple[int, int]]) -> int:
    """Time receptive field (frames) of a CnnAvgPooling stack.

    Each ConvBlock adds two k=3 convs (+2 frames each at the current stride),
    then multiplies the stride by its pool factor.
    """
    rf, stride = 1, 1
    for _, pool in model_config:
        rf += 4 * stride
        stride *= pool
    return rf

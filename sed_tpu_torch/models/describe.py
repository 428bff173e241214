"""Model descriptions: parameter counts and shape walkthroughs (counterpart of
``sed_tpu.models.describe``; the strings are ``sed_tpu``'s).
"""

from __future__ import annotations

from torch import nn

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig, human_format
from sed_tpu_torch.models.cnn import num_pools


def count_parameters(model: nn.Module) -> int:
    """Learnable parameters (BN running statistics are buffers, not counted).

    For CnnAvgPooling and M5 this is ``sed_tpu``'s count of its flax
    parameters; MobileNetV1 counts 128 more, its never-called ``bn0``, as
    the reference's torch model does.
    """
    return sum(p.numel() for p in model.parameters())


def describe_cnn(model, cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM) -> str:
    """Shape walkthrough of a CnnAvgPooling on a 60 s clip."""
    lines = ["Model description"]
    b = "b"
    w = cfg.mel_bins
    h = 60 * cfg.working_sample_rate // cfg.hop_size
    c = cfg.audio_channels
    classes = model.event_fc.out_features
    lines.append(f"\tInput: ({b}, {c}, {h}, {w})")
    for c_out, k in model.model_config:
        h //= k
        w //= k
        lines.append(f"\tconv_block -> ({b}, {c_out}, {h}, {w})")
    last_c = model.model_config[-1][0]
    lines.append(f"\tmean(dim=3) -> ({b}, {last_c}, {h})")
    lines.append(f"\ttranspose(1,2) -> ({b}, {h}, {last_c})")
    lines.append(f"\tFC -> ({b}, {h}, {classes})")
    pools = num_pools(model.model_config)
    num_outputs = h
    h *= 2 ** pools
    frame_duration = cfg.hop_size / cfg.working_sample_rate
    lines.append(f"\tinterpolate({2 ** pools}) -> ({b}, {h}, {classes})")
    lines.append(
        f"\tModel has {num_outputs} outputs before interpolation, each stands for "
        f"{2 ** pools} frames or {2 ** pools * frame_duration:.2f}s"
    )
    lines.append(f"\tModel has {human_format(count_parameters(model))} parameters")
    return "\n".join(lines)


def describe_m5(model) -> str:
    """One-line summary of an M5."""
    return (
        "Waveform model:\n"
        f"\t- Model has {human_format(count_parameters(model))} parameters"
    )

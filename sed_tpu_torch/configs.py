"""Frozen configuration dataclasses (counterpart of ``sed_tpu.configs``).

The port's own copy: same defaults and derived properties, so a config built
here describes the same geometry as its ``sed_tpu`` twin.  Defaults are the
reference's constants:

  * working_sample_rate = 48000, time_margin = 0.33 s
  * frame_size = 31680, hop_size = 15840, frames_per_second = 3
  * NFFT = 32768, mel_bins = 64, mel range [20 Hz, sr/2]
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def human_format(num: float) -> str:
    """Format a number with K/M/G suffixes: 48000 -> '48.0K'."""
    magnitude = 0
    num = float(num)
    while abs(num) >= 1000:
        magnitude += 1
        num /= 1000.0
    return "%.1f%s" % (num, ["", "K", "M", "G", "T", "P"][magnitude])


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Shared audio constants."""

    working_sample_rate: int = 48000
    time_margin: float = 0.33
    audio_channels: int = 1
    min_event_percentage_in_positive_frame: float = 0.74
    tau_sed_labels: Tuple[str, ...] = ("doorslam",)

    @property
    def frame_size(self) -> int:
        return int(self.working_sample_rate * self.time_margin * 2)

    @property
    def hop_size(self) -> int:
        return self.frame_size // 2

    @property
    def frames_per_second(self) -> int:
        return self.working_sample_rate // self.hop_size

    @property
    def classes_num(self) -> int:
        return len(self.tau_sed_labels)


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig(AudioConfig):
    """Spectrogram feature constants."""

    mel_bins: int = 64
    mel_min_freq: float = 20.0

    @property
    def nfft(self) -> int:
        return 2 ** int(math.ceil(math.log2(self.frame_size)))

    @property
    def mel_max_freq(self) -> float:
        return self.working_sample_rate // 2

    @property
    def freq_bins(self) -> int:
        return self.nfft // 2 + 1

    @property
    def train_crop_size(self) -> int:
        return self.frames_per_second * 10

    @property
    def cfg_descriptor(self) -> str:
        """Name of the feature cache directory."""
        return (
            f"Spectogram_SaR-{human_format(self.working_sample_rate)}"
            f"_FrS-{human_format(self.frame_size)}"
            f"_HoS-{human_format(self.hop_size)}"
            f"_Mel-{self.mel_bins}"
            f"_Ch-{self.audio_channels}"
        )


@dataclasses.dataclass(frozen=True)
class WaveformConfig(AudioConfig):
    """Waveform feature constants (the M5 family)."""

    @property
    def cfg_descriptor(self) -> str:
        return (
            f"WaveForm_SaR-{human_format(self.working_sample_rate)}"
            f"_FrS-{human_format(self.frame_size)}"
            f"_HoS-{human_format(self.hop_size)}"
            f"_Ch-{self.audio_channels}"
        )


DEFAULT_AUDIO = AudioConfig()
DEFAULT_SPECTROGRAM = SpectrogramConfig()
DEFAULT_WAVEFORM = WaveformConfig()

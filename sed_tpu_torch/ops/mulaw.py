"""µ-law companded 8-bit ingest tier (counterpart of ``sed_tpu.ops.mulaw``).

Repo-wide dtype conventions on the featurizer ingest path:

  * ``int16``  means PCM16    — de-quantized by 1/32768
  * ``uint8``  means µ-law    — decoded by :func:`mulaw_decode`
  * floating   means waveform — passed through as float32

The byte is sign-magnitude: bit 7 = sign, bits 0-6 = round(|y| * 127) with
y = ln(1 + µ|x|)/ln(1 + µ), µ = 255, so silence encodes to 0x00 and decodes
to exactly 0.0.  A lossy serving wire format, never the parity path.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0
_LOG1P_MU = float(np.log1p(MU))  # ln(256)


def mulaw_encode(x) -> np.ndarray:
    """Host-side encoder: waveform -> uint8 µ-law bytes (numpy).

    ``x``: float array in [-1, 1] (values are clipped) or int16 PCM16
    (de-quantized by 1/32768 first).
    """
    x = np.asarray(x)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    mag = np.log1p(MU * np.abs(x)) / _LOG1P_MU            # [0, 1]
    m7 = np.round(mag * 127.0).astype(np.uint8)           # [0, 127]
    sign = (x < 0).astype(np.uint8) << 7
    return sign | m7


def mulaw_decode(u8: torch.Tensor) -> torch.Tensor:
    """uint8 µ-law bytes -> float32 waveform, on the tensor's device."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"mulaw_decode expects uint8, got {u8.dtype}")
    m7 = torch.bitwise_and(u8, 0x7F).to(torch.float32) / 127.0
    mag = torch.expm1(m7 * _LOG1P_MU) / MU
    return torch.where(torch.bitwise_and(u8, 0x80) != 0, -mag, mag)


def mulaw_decode_np(u8) -> np.ndarray:
    """Host-side decoder: uint8 µ-law bytes -> float32 waveform (numpy), the
    numpy twin of :func:`mulaw_decode` for host staging, tools and tests."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise TypeError(f"mulaw_decode_np expects uint8, got {u8.dtype}")
    m7 = (u8 & 0x7F).astype(np.float32) / 127.0
    mag = np.expm1(m7.astype(np.float64) * _LOG1P_MU) / MU
    sign = np.where((u8 & 0x80) != 0, -1.0, 1.0)
    return (sign * mag).astype(np.float32)

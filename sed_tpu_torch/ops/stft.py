"""Centred STFT with librosa semantics (counterpart of ``sed_tpu.ops.stft``).

The reference calls ``librosa.core.stft(y, n_fft=32768, win_length=31680,
hop_length=15840, window=np.hanning(31680), center=True, pad_mode='reflect')``:

  1. the symmetric Hann window ``np.hanning(win_length)`` is zero-padded
     centred into the n_fft buffer (left pad (n_fft - win_length) // 2 = 544);
  2. the signal is reflect-padded by n_fft//2 on both sides (the edge sample
     is not repeated, as ``jnp.pad(mode="reflect")``);
  3. frames of n_fft samples are taken every hop: n_frames = 1 + len // hop;
  4. each frame is windowed and goes through a real FFT (n_fft//2 + 1 bins).

Two FFT backends, as in ``sed_tpu`` (``fft_impl``):

  * ``'fft'`` — ``torch.fft.rfft``, accurate float32 on CPU and GPU alike,
    so it is the default on every device (:func:`default_fft_impl`);
  * ``'matmul'`` — the two-stage Cooley-Tukey matmul rFFT of ``sed_tpu``
    (:func:`rfft_matmul_realimag`), which exists there because the TPU has
    no accurate native FFT.  Its stages are ``torch.matmul`` in full float32
    (TF32 off), as ``sed_tpu`` leaves them to XLA at Precision.HIGHEST.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.utils.precision import full_float32


def symmetric_hann(win_length: int) -> np.ndarray:
    """np.hanning: 0.5 - 0.5*cos(2*pi*n/(N-1)), zero at both endpoints."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))


@functools.lru_cache(maxsize=8)
def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Symmetric Hann centred in an n_fft-length zero buffer (float64 -> float32)."""
    w = symmetric_hann(win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad:lpad + win_length] = w
    out = out.astype(np.float32)
    out.setflags(write=False)
    return out


def num_frames(n_samples: int, hop: int) -> int:
    """Frame count for a centre-padded STFT: 1 + floor(n / hop)."""
    return 1 + n_samples // hop


def reflect_indices(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each sample of a signal of ``n`` samples
    reflect-padded by ``pad`` on both sides, as ``np.pad(mode="reflect")``:
    the edge sample is not repeated, and pads longer than the signal
    reflect again (period 2(n-1))."""
    if n < 1:
        raise ValueError("cannot reflect-pad an empty signal")
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft) reflect-centred frames (a view
    of one padded copy of the signal)."""
    ypad = y[..., reflect_indices(y.shape[-1], n_fft // 2, y.device)]
    return ypad.unfold(-1, n_fft, hop)


def windowed_frames(y: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    window = torch.tensor(padded_window(cfg.frame_size, cfg.nfft),
                          dtype=y.dtype, device=y.device)
    return frame_signal(y, cfg.nfft, cfg.hop_size) * window


# ---------------------------------------------------------------------------
# Matmul rFFT: N = N1 * N2 Cooley-Tukey with the DFT stages as matmuls.
# ---------------------------------------------------------------------------

def _dft_matrix(n: int) -> np.ndarray:
    """(n, n) complex128 DFT matrix W[k, m] = exp(-2j*pi*k*m/n)."""
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


@functools.lru_cache(maxsize=4)
def _matmul_fft_constants(n_fft: int):
    """Split-radix constants of the two-stage matmul FFT (the port's copy of
    ``sed_tpu``'s): n_fft = n1 * n2 with n1 = 2**(log2(n_fft)//2), the inner
    (n2, n2) and outer (n1, n1) DFT matrices and the (n2, n1) twiddles
    W_N^(n1_idx * k2), computed in float64 and rounded once to float32.
    Returns ``n1, n2, (w2r, w2i), (w1r, w1i), (twr, twi)`` as numpy arrays."""
    k = int(np.log2(n_fft))
    if 2 ** k != n_fft:
        raise ValueError(f"matmul FFT requires a power-of-two size, got {n_fft}")
    n1 = 2 ** (k // 2)
    n2 = n_fft // n1
    tw = np.exp(-2j * np.pi * np.arange(n2)[:, None] * np.arange(n1)[None, :] / n_fft)

    def f32(c):
        return c.real.astype(np.float32), c.imag.astype(np.float32)

    return n1, n2, f32(_dft_matrix(n2)), f32(_dft_matrix(n1)), f32(tw)


def _cfft_matmul(xr: torch.Tensor, xi: torch.Tensor, m: int):
    """Complex FFT of length m on (real, imag) float32 tensors via two
    Cooley-Tukey stages, each a dense matmul; natural-order output."""
    n1, n2, w2, w1, tw = _matmul_fft_constants(m)
    (w2r, w2i), (w1r, w1i), (twr, twi) = (
        tuple(torch.from_numpy(a).to(xr.device) for a in pair) for pair in (w2, w1, tw))
    batch = xr.shape[:-1]
    xr = xr.reshape(batch + (n2, n1))
    xi = xi.reshape(batch + (n2, n1))
    with full_float32():
        # Inner DFT over n2: Y[k2, n1] = sum_n2 W2[k2, n2] x[n2, n1] (complex).
        yr = torch.matmul(w2r, xr) - torch.matmul(w2i, xi)
        yi = torch.matmul(w2r, xi) + torch.matmul(w2i, xr)
        # Twiddle (elementwise on (k2, n1)).
        yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
        # Outer DFT over n1: X[k2, k1] = sum_n1 Y[k2, n1] W1[n1, k1].
        zr = torch.matmul(yr, w1r) - torch.matmul(yi, w1i)
        zi = torch.matmul(yr, w1i) + torch.matmul(yi, w1r)
    # X[n2*k1 + k2] = Z[k2, k1] -> transpose to (k1, k2) and flatten.
    return (zr.transpose(-1, -2).reshape(batch + (m,)),
            zi.transpose(-1, -2).reshape(batch + (m,)))


@functools.lru_cache(maxsize=8)
def unpack_twiddles(n_fft: int):
    """cos and sin of -2*pi*k/n_fft for k < n_fft/2 (W_N^k of the hermitian
    unpack), computed in float64 and rounded once to float32."""
    theta = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    c, s = np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)
    c.setflags(write=False)
    s.setflags(write=False)
    return c, s


def stockham_radices(m: int) -> list:
    """Radices of K6's Stockham FFT passes over m = 2^k points:
    m = 16^a * r with r in {1, 2, 4, 8}, a radix-16 passes then one radix-r
    pass where r > 1."""
    a, rest = divmod(m.bit_length() - 1, 4)
    return [16] * a + ([1 << rest] if rest else [])


@functools.lru_cache(maxsize=8)
def stockham_twiddles(n_fft: int):
    """cos and sin of K6's inter-pass twiddles in pass order, m = n_fft/2
    entries: for the pass of radix R after p points' worth of earlier
    radices, entry q*p + k - 1 holds W_{pR}^(q*k) (0 < q < R, 0 <= k < p),
    so a warp's neighbouring k read neighbouring entries.  The values are
    :func:`unpack_twiddles`' W_N^j at j = q*k*N/(pR) (W_N^(j+m) = -W_N^j),
    rearranged, not recomputed; the last entry is padding."""
    m = n_fft // 2
    c, s = unpack_twiddles(n_fft)
    out_c, out_s = np.ones(m, np.float32), np.zeros(m, np.float32)
    p = 1
    for r in stockham_radices(m):
        q, k = np.meshgrid(np.arange(1, r), np.arange(p), indexing="ij")
        j = q * k * (n_fft // (p * r))
        sign = np.where(j < m, 1.0, -1.0).astype(np.float32)
        pos = q * p + k - 1
        out_c[pos] = sign * c[j % m]
        out_s[pos] = sign * s[j % m]
        p *= r
    out_c.setflags(write=False)
    out_s.setflags(write=False)
    return out_c, out_s


def hermitian_unpack(zr: torch.Tensor, zi: torch.Tensor, n_fft: int):
    """Z = FFT_M(x_even + i*x_odd) of real frames (M = n_fft/2, natural bin
    order) -> (real, imag) of their real DFT, each (..., M + 1):
      E[k] = (Z[k] + conj(Z[M-k]))/2,  O[k] = (Z[k] - conj(Z[M-k]))/(2i),
      X[k] = E[k] + W_N^k O[k],        X[M] = E[0] - O[0] (purely real).
    Computes in the dtype of ``zr``."""
    c, s = (torch.tensor(a, dtype=zr.dtype, device=zr.device)
            for a in unpack_twiddles(n_fft))
    # conj(Z[(M-k) mod M]): index 0 stays, the rest reversed.
    zrev_r = torch.roll(zr.flip(-1), 1, dims=-1)
    zrev_i = -torch.roll(zi.flip(-1), 1, dims=-1)
    er = 0.5 * (zr + zrev_r)
    ei = 0.5 * (zi + zrev_i)
    orr = 0.5 * (zi - zrev_i)
    oi = -0.5 * (zr - zrev_r)
    xr = torch.cat([er + c * orr - s * oi, er[..., :1] - orr[..., :1]], dim=-1)
    xi = ei + c * oi + s * orr
    return xr, torch.cat([xi, torch.zeros_like(xi[..., :1])], dim=-1)


def rfft_matmul_realimag(frames: torch.Tensor, n_fft: int):
    """Real FFT of (..., n_fft) frames as matmuls: (real, imag) float32, each
    (..., n_fft//2 + 1): even/odd packing z[n] = x[2n] + i*x[2n+1] through
    the two-stage matmul complex FFT of length n_fft/2 (half the work of a
    length-n_fft transform), then :func:`hermitian_unpack`."""
    m = n_fft // 2
    x = frames.to(torch.float32).reshape(frames.shape[:-1] + (m, 2))
    zr, zi = _cfft_matmul(x[..., 0], x[..., 1], m)
    return hermitian_unpack(zr, zi, n_fft)


def rfft_matmul(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Complex-output wrapper over :func:`rfft_matmul_realimag`."""
    return torch.complex(*rfft_matmul_realimag(frames, n_fft))


def default_fft_impl() -> str:
    """'fft' on every device: torch's FFT is accurate float32 on CPU and GPU
    (``sed_tpu`` picks 'matmul' only on a TPU backend)."""
    return "fft"


def _resolve_fft_impl(fft_impl: str) -> str:
    if fft_impl == "auto":
        return default_fft_impl()
    if fft_impl not in ("fft", "matmul"):
        raise ValueError(f"unknown fft_impl {fft_impl!r}: expected 'fft', 'matmul' "
                         f"or 'auto'")
    return fft_impl


def rfft_realimag(frames: torch.Tensor, n_fft: int, fft_impl: str = "auto"):
    """Real FFT of (..., n_fft) windowed frames by ``fft_impl``: (real,
    imag), each (..., n_fft//2 + 1)."""
    if _resolve_fft_impl(fft_impl) == "matmul":
        return rfft_matmul_realimag(frames, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real, spec.imag


def stft_realimag(y: torch.Tensor,
                  cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                  fft_impl: str = "auto"):
    """(..., samples) -> ((..., frames, bins) real, (..., frames, bins) imag)."""
    return rfft_realimag(windowed_frames(y, cfg), cfg.nfft, fft_impl)


def stft(y: torch.Tensor,
         cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
         fft_impl: str = "fft") -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft//2+1) complex, frames-major."""
    frames = windowed_frames(y, cfg)
    if _resolve_fft_impl(fft_impl) == "matmul":
        return rfft_matmul(frames, cfg.nfft)
    return torch.fft.rfft(frames, dim=-1)

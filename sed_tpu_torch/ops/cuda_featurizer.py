"""The featurizer's two CUDA kernels, their wrappers and their plain versions.

Counterpart of ``sed_tpu/ops/pallas_featurizer.py``.  The kernels are CUDA
C++ for Hopper in ``csrc/featurizer.cu`` (see its header for what each one
replaces, what bounds it and how it is designed):

  * K1 :func:`wave_stft_power` — waveforms (n_sig, samples) f32 ->
    one-sided power (n_sig, n_frames, n_fft/2+1) f32 of the centred,
    reflect-padded, windowed real DFT, in natural bin order;
  * K2 :func:`mel_log` — power (rows, n_fft/2+1) f32 -> (rows, mel) f32
    10*log10(max(1e-10, power @ fb)) over the sparse band description;
  * K3 :func:`frames_stft_power` — pre-framed rows (rows, n_fft) f32 or
    int16 -> one-sided power (rows, n_fft/2+1) f32 of the windowed real DFT
    (the streaming tick's featurizer, followed by K2).

Each wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain PyTorch version beside it (:func:`wave_stft_power_plain`,
:func:`mel_log_plain`, :func:`frames_stft_power_plain`); a CUDA tensor
launches the kernel or raises.  There is no fallback from a failed build or
launch to the plain version.

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` into
``_build/`` next to this file (git-ignored), as a shared library with a
plain C interface, loaded with ctypes.  ``LAUNCHES`` counts the kernel
launches of each wrapper, so a caller can show that a run went through the
kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops import stft as stft_ops

SOURCE = Path(__file__).resolve().parent / "csrc" / "featurizer.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Largest dynamic shared memory a Hopper block can use (227 KB); K1 keeps
# n_fft/2 complex f32 points there.
_MAX_SMEM_BYTES = 232448
_MAX_GRID_X = 2**31 - 1

LAUNCHES = {"wave_stft_power": 0, "mel_log": 0, "frames_stft_power": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str        # nvcc's output, including -Xptxas -v resource usage


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(nvcc):
            return nvcc
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA featurizer kernels are "
                           "built from source at first use and need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def build(force: bool = False) -> BuildInfo:
    """Compile ``csrc/featurizer.cu`` into ``_build/``.

    The library's name carries a hash of the source and flags, so an edited
    source is rebuilt and an unchanged one is reused unless ``force``.  The
    build writes a temporary file and renames it, so concurrent processes
    never load a half-written library.
    """
    src = SOURCE.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    path = BUILD_DIR / f"libsed_featurizer_{digest}.so"
    if path.exists() and not force:
        return BuildInfo(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return BuildInfo(path, seconds, log)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sed_error_string.argtypes = [i32]
    lib.sed_error_string.restype = ctypes.c_char_p
    lib.sed_wave_stft_power.argtypes = [vp, vp, vp, vp, i64, i64, i32, i32,
                                        i32, i32, vp]
    lib.sed_wave_stft_power.restype = i32
    lib.sed_mel_log.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.sed_mel_log.restype = i32
    lib.sed_frames_stft_power.argtypes = [vp, i32, vp, vp, vp, i64, i32, i32, vp]
    lib.sed_frames_stft_power.restype = i32
    return lib


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        msg = _library().sed_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")


def _require_cuda_f32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_fft_size(n_fft: int, window: torch.Tensor) -> None:
    if n_fft < 4 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft must be a power of two >= 4, got {n_fft}")
    if (n_fft // 2) * 8 > _MAX_SMEM_BYTES:
        raise ValueError(f"n_fft {n_fft} does not fit the shared-memory FFT")
    if window.shape != (n_fft,):
        raise ValueError(f"window must be ({n_fft},), got {tuple(window.shape)}")


# ---------------------------------------------------------------------------
# K1: waveform -> one-sided STFT power
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """(n_fft/2, 2) f32 table of W_N^k = exp(-2*pi*i*k/N), from float64."""
    theta = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    tw = np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def wave_stft_power_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                          n_fft: int) -> torch.Tensor:
    """Plain version of K1: reflect-centred framing, window, torch.fft.rfft,
    re^2 + im^2.  Computes in the dtype of ``waves`` (float32 or float64)."""
    frames = stft_ops.frame_signal(waves, n_fft, hop) * window.to(waves.dtype)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def wave_stft_power(waves: torch.Tensor, window: torch.Tensor, hop: int,
                    n_fft: int) -> torch.Tensor:
    """(n_sig, samples) f32 -> (n_sig, 1 + samples // hop, n_fft/2 + 1) f32
    power of the centred, reflect-padded, windowed real DFT.

    CPU tensors take :func:`wave_stft_power_plain`; CUDA tensors launch K1.
    Unlike the TPU kernel, which emits all n_fft bins in its (k2, k1) tile
    layout for a folded filterbank, this returns the one-sided spectrum in
    natural order: the same mel product, without Mosaic's layout.
    """
    if waves.device.type == "cpu":
        return wave_stft_power_plain(waves, window, hop, n_fft)
    if waves.device.type != "cuda":
        raise ValueError(f"wave_stft_power: unsupported device {waves.device}")
    device = waves.device
    _require_cuda_f32("waves", waves, device)
    _require_cuda_f32("window", window, device)
    if waves.ndim != 2 or waves.shape[1] < 1:
        raise ValueError(f"waves must be (n_signals, samples>0), got {tuple(waves.shape)}")
    _check_fft_size(n_fft, window)
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    n_sig, n_samples = waves.shape
    n_frames = stft_ops.num_frames(n_samples, hop)
    if n_sig * n_frames > _MAX_GRID_X:
        raise ValueError(f"{n_sig * n_frames} frames exceed one launch's grid")
    out = torch.empty((n_sig, n_frames, n_fft // 2 + 1), dtype=torch.float32,
                      device=device)
    if n_sig == 0:
        return out
    tw = _twiddles(n_fft, device)
    log2_m = n_fft.bit_length() - 2  # log2(n_fft / 2) complex points
    err = _library().sed_wave_stft_power(
        waves.data_ptr(), window.data_ptr(), tw.data_ptr(), out.data_ptr(),
        n_sig, n_samples, n_frames, hop, log2_m, device.index, _stream(device))
    _check_launch("wave_stft_power", err)
    LAUNCHES["wave_stft_power"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: pre-framed rows -> one-sided STFT power
# ---------------------------------------------------------------------------

def frames_stft_power_plain(frames: torch.Tensor, window: torch.Tensor, n_fft: int,
                            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of K3: window, torch.fft.rfft, re^2 + im^2.

    Computes in ``dtype``: by default float64 for float64 frames and float32
    otherwise.  int16 rows are PCM16: the window is scaled by 1/32768, as the
    kernel does.
    """
    if frames.shape[-1] != n_fft:
        raise ValueError(f"frames must be (rows, {n_fft}), got {tuple(frames.shape)}")
    if dtype is None:
        dtype = torch.float64 if frames.dtype == torch.float64 else torch.float32
    w = window.to(dtype)
    if frames.dtype == torch.int16:
        w = w / 32768.0
    spec = torch.fft.rfft(frames.to(dtype) * w, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def frames_stft_power(frames: torch.Tensor, window: torch.Tensor,
                      n_fft: int) -> torch.Tensor:
    """(rows, n_fft) f32 or int16 frames -> (rows, n_fft/2 + 1) f32 power of
    the windowed real DFT, one-sided and in natural bin order.

    CPU tensors take :func:`frames_stft_power_plain`; CUDA tensors launch K3.
    ``window`` is the f32 window of float frames; for int16 (PCM16) frames
    the wrapper scales it by 1/32768 on the card (exact: a power of two), as
    ``stft_power_pallas`` does, so de-quantization costs the kernel nothing.
    """
    if frames.device.type == "cpu":
        return frames_stft_power_plain(frames, window, n_fft)
    if frames.device.type != "cuda":
        raise ValueError(f"frames_stft_power: unsupported device {frames.device}")
    device = frames.device
    if frames.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"frames must be float32 or int16, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    _require_cuda_f32("window", window, device)
    _check_fft_size(n_fft, window)
    if frames.ndim != 2 or frames.shape[1] != n_fft:
        raise ValueError(f"frames must be (rows, {n_fft}), got {tuple(frames.shape)}")
    rows = frames.shape[0]
    if rows > _MAX_GRID_X:
        raise ValueError(f"{rows} rows exceed one launch's grid")
    out = torch.empty((rows, n_fft // 2 + 1), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    is_int16 = frames.dtype == torch.int16
    if is_int16:
        window = window / 32768.0
    tw = _twiddles(n_fft, device)
    err = _library().sed_frames_stft_power(
        frames.data_ptr(), int(is_int16), window.data_ptr(), tw.data_ptr(),
        out.data_ptr(), rows, n_fft.bit_length() - 2, device.index, _stream(device))
    _check_launch("frames_stft_power", err)
    LAUNCHES["frames_stft_power"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: power -> log-mel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MelBands:
    """The filterbank as K2 reads it, plus the dense form its plain version
    uses.  Band b weights bins [lo[b], hi[b]) with
    ``weights[offset[b] : offset[b] + hi[b] - lo[b]]``."""

    lo: torch.Tensor       # (n_mels,) int32
    hi: torch.Tensor       # (n_mels,) int32
    offset: torch.Tensor   # (n_mels,) int32
    weights: torch.Tensor  # (nnz,) float32
    dense: torch.Tensor    # (n_bins, n_mels) float32

    @property
    def n_bins(self) -> int:
        return self.dense.shape[0]

    @property
    def n_mels(self) -> int:
        return self.dense.shape[1]


def mel_bands_numpy(fb: np.ndarray):
    """(n_bins, n_mels) filterbank -> (lo, hi, offset, weights) numpy arrays:
    per band the range from its first to its last non-zero bin."""
    lo, hi, offset, parts = [], [], [], []
    total = 0
    for b in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, b])
        a, e = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        hi.append(e)
        offset.append(total)
        parts.append(fb[a:e, b])
        total += e - a
    as_i32 = functools.partial(np.asarray, dtype=np.int32)
    weights = np.concatenate(parts).astype(np.float32)
    return as_i32(lo), as_i32(hi), as_i32(offset), weights


@functools.lru_cache(maxsize=8)
def mel_bands(cfg: SpectrogramConfig, device: torch.device) -> MelBands:
    """K2's band description of ``cfg``'s filterbank (float64 cast to f32)."""
    fb = mel_ops.mel_filterbank(cfg, dtype=np.float32)
    lo, hi, offset, weights = mel_bands_numpy(fb)
    return MelBands(*(torch.from_numpy(a).to(device)
                      for a in (lo, hi, offset, weights, fb)))


@functools.lru_cache(maxsize=8)
def stft_window(cfg: SpectrogramConfig, device: torch.device) -> torch.Tensor:
    """The padded Hann window of ``cfg`` as a f32 tensor on ``device``."""
    return torch.from_numpy(
        stft_ops.padded_window(cfg.frame_size, cfg.nfft).copy()).to(device)


def mel_log_plain(power: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: dense ``power @ fb`` (TF32 off), clamp, 10*log10.
    Computes in the dtype of ``power`` (float32 or float64)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        melp = torch.matmul(power, fb.to(power.dtype))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return mel_ops.power_to_db(melp)


def mel_log(power: torch.Tensor, bands: MelBands) -> torch.Tensor:
    """(rows, n_bins) f32 power -> (rows, n_mels) f32 log-mel.

    CPU tensors take :func:`mel_log_plain`; CUDA tensors launch K2.
    """
    if power.device.type == "cpu":
        return mel_log_plain(power, bands.dense)
    if power.device.type != "cuda":
        raise ValueError(f"mel_log: unsupported device {power.device}")
    device = power.device
    _require_cuda_f32("power", power, device)
    for name in ("lo", "hi", "offset"):
        t = getattr(bands, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"bands.{name} must be contiguous int32 on {device}")
    _require_cuda_f32("bands.weights", bands.weights, device)
    if power.ndim != 2 or power.shape[1] != bands.n_bins:
        raise ValueError(f"power must be (rows, {bands.n_bins}), got {tuple(power.shape)}")
    rows = power.shape[0]
    if rows > _MAX_GRID_X:
        raise ValueError(f"{rows} rows exceed one launch's grid")
    out = torch.empty((rows, bands.n_mels), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    err = _library().sed_mel_log(
        power.data_ptr(), bands.lo.data_ptr(), bands.hi.data_ptr(),
        bands.offset.data_ptr(), bands.weights.data_ptr(), out.data_ptr(),
        rows, bands.n_bins, bands.n_mels, device.index, _stream(device))
    _check_launch("mel_log", err)
    LAUNCHES["mel_log"] += 1
    return out

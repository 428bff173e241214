"""The featurizer's CUDA kernels, their wrappers and their plain versions.

Counterpart of ``sed_tpu/ops/pallas_featurizer.py``.  The kernels are CUDA
C++ for Hopper in ``csrc/featurizer.cu`` (see its header for what each one
replaces, what bounds it and how it is designed):

  * K1 :func:`wave_stft_power` — waveforms (n_sig, samples) f32 ->
    one-sided power (n_sig, n_frames, n_fft/2+1) f32 of the centred,
    reflect-padded, windowed real DFT, in natural bin order;
  * K2 :func:`mel_log` — power (rows, n_fft/2+1) f32 -> (rows, mel) f32
    10*log10(max(1e-10, power @ fb)) over the sparse band description cut
    into segments (:class:`MelBands`), each row read once through shared
    memory (also sed_tpu's K4, :func:`power_to_logmel_cuda`);
  * K3 :func:`frames_stft_power` — pre-framed rows (rows, n_fft) f32 or
    int16 -> one-sided power (rows, n_fft/2+1) f32 of the windowed real DFT
    (the streaming tick's featurizer, followed by K2);
  * K5 :func:`wave_stft_mel_log` — K1 then K2 in one launch, waveforms ->
    (n_sig, n_frames, mel) f32 with no power array in device memory;
  * K6 :func:`wave_packed_fft` — waveforms -> (Zr, Zi), each (n_sig,
    n_frames, n_fft/2) f32, the packed complex FFT of each frame;
  * K1t :func:`wave_dft_power_bf16` and K3t :func:`frames_dft_power_bf16` —
    K1's and K3's functions at sed_tpu's reduced-precision tiers ('fast'
    bf16x3, 'turbo' bf16x1, the raw 'bf16xN' strings and per-stage pairs):
    sed_tpu's two-stage matmul DFT with each product split into bf16 chunks
    as its ``_make_dot`` splits them, on the tensor cores (the split pass,
    ``tier_split_kernel``, with K1's framing or K3's rows, then one
    persistent wgmma kernel of both stages, ``tier_fused_kernel``, or the
    tier GEMMs: :func:`fused_plan` says which).  K2 takes sed_tpu's
    ``mel_precision`` 'bf16x1' and 'bf16x3' as product modes;
  * K5t :func:`wave_stft_mel_log_bf16` — K1t's launches, then K2; and K5b,
    K5 at K2's modes (:func:`wave_stft_mel_log`'s ``mel_precision``);
  * K6t :func:`wave_packed_fft_bf16` — K6's function by the same bf16 matmul
    DFT over the m = n_fft/2 packed points (a complex input).

Every kernel takes every power-of-two n_fft that sed_tpu computes for its
impl and precision, up to :data:`MAX_FFT_SIZE` (2^20); :func:`launch_plan`
says what each launches at a size, and the wrappers' checks read the same
functions.  Above n_fft 131072 K1, K3 and K6 run a global cross pass, the
sub-rows' cluster FFT and (K1, K3) an unpack, and K5 runs K1's launches then
K2; K1t and K3t run a split pass to bf16 chunk planes, then, where the
library's :func:`fused_plan` takes the size, the fused kernel (a frame group a
launch), elsewhere (and K6t outside its instances' sizes) the tier GEMMs' two
wgmma stages (:func:`gemm_plan`); K5t runs K1t's launches, then K2.

Each wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain PyTorch version beside it (:func:`wave_stft_power_plain`,
:func:`mel_log_plain`, :func:`frames_stft_power_plain`,
:func:`wave_stft_mel_log_plain`, :func:`wave_packed_fft_plain`,
:func:`wave_dft_power_bf16_plain`, :func:`frames_dft_power_bf16_plain`,
:func:`wave_stft_mel_log_bf16_plain`, :func:`wave_packed_fft_bf16_plain`); a
CUDA tensor launches the kernel or raises.  There is no fallback from a failed
build or launch to the plain version.

The drivers at the end carry ``sed_tpu``'s names without ``_pallas``
(:func:`logmel_waveform` with every ``impl`` name,
:func:`stft_power_from_waveform`, :func:`stft_eo_power_from_waveform`,
:func:`stft_packed_from_waveform`, :func:`logmel_waveform_fused`, ...) and
map each of sed_tpu's ten TPU kernels, at each of its tiers, onto these.

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` into
``_build/`` next to this file (git-ignored), as a shared library with a
plain C interface, loaded with ctypes; :func:`install_library` puts a
library built elsewhere from the same source there instead (the serving
artifacts of ``sed_tpu_torch.export`` carry one).  ``LAUNCHES`` counts the
kernel launches of each wrapper, so a caller can show that a run went
through the kernels.

K1, K2 and K1t are also registered as the custom operators
``torch.ops.sed_tpu_torch.wave_stft_power``, ``torch.ops.sed_tpu_torch.mel_log``
and ``torch.ops.sed_tpu_torch.wave_dft_power_bf16``, whose CPU kernels are
the plain versions and whose CUDA kernels are the launches; their wrappers
call them, so a ``torch.export`` program holds the kernels and counts their
launches as eager calls do.  K3, K3t, K5, K5t, K6, K6t and K2's bf16
product modes are bound directly: a program that exports their paths needs
the same wrapping first.
"""

from __future__ import annotations

import concurrent.futures
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

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops import stft as stft_ops
from sed_tpu_torch.utils.precision import full_float32

SOURCE = Path(__file__).resolve().parent / "csrc" / "featurizer.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# How build() makes the library, and all that library_digest() hashes beside
# the source: each unit's macro picks one object of the source (featurizer.cu:
# the instances of each tier kernel, K1t/K3t's fused kernel, K6t at n1 32
# and 64, K6t at n1 128 and 256, the split pass and the tier GEMMs,
# then everything else), the objects are compiled side by side with "compile" and
# joined by one nvcc with "link".
BUILD_RECIPE = {
    "compile": tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",),
    "units": ("-DSED_FEATURIZER_TIERS_ONLY", "-DSED_FEATURIZER_PACKED_TIERS_ONLY",
              "-DSED_FEATURIZER_WIDE_PACKED_ONLY", "-DSED_FEATURIZER_GEMM_TIERS_ONLY",
              "-DSED_FEATURIZER_NO_TIERS"),
    "link": ("-shared",),
}

# Largest dynamic shared memory a Hopper block can use (227 KB); the FFT
# kernels keep n_fft/2 complex f32 points there (K5 also the power row), or,
# above n_fft 32768, 2^14 of them in each CTA of a thread-block cluster of
# n_fft / 32768 CTAs (at most _MAX_CLUSTER_CTAS); above n_fft 131072 a global
# cross pass splits a frame into sub-rows of 2^16 points, each such a cluster.
_MAX_SMEM_BYTES = 232448
_CTA_FFT_POINTS = stft_ops.CTA_FFT_POINTS
_MAX_CLUSTER_CTAS = 4
CLUSTER_FFT_MAX = 2 * _CTA_FFT_POINTS * _MAX_CLUSTER_CTAS   # 131072: one cluster a frame
# The largest n_fft any featurizer kernel takes: 1.536 MHz at sed_tpu's frame
# of 0.66 s (rates above it are not audio).
MAX_FFT_SIZE = 1 << 20
_SUB_ROW_POINTS = stft_ops.SUB_ROW_POINTS
_SUB_ROW_LOG2 = _SUB_ROW_POINTS.bit_length() - 1
_MAX_GRID_X = 2**31 - 1

# Launches of each kernel: a wrapper adds one to its own name where it
# launches its one-launch instance; on the routes that take more than one
# launch (:func:`launch_plan`) it adds one to the name of each kernel it
# launches (the cross pass, the sub-row FFTs and the unpack of the Stockham
# FFT above n_fft 131072; the tier GEMMs' split pass and two stages, once a
# frame group each; K2 where K5 and K5t chain), and on K1t's and K3t's
# fused route (K5t's first part) one to the split pass's and one to its own,
# once a frame group each.
LAUNCHES = {"wave_stft_power": 0, "mel_log": 0, "frames_stft_power": 0,
            "wave_stft_mel_log": 0, "wave_packed_fft": 0, "wave_dft_power_bf16": 0,
            "frames_dft_power_bf16": 0, "mel_log_bf16": 0, "wave_stft_mel_log_mel_bf16": 0,
            "wave_stft_mel_log_bf16": 0, "wave_packed_fft_bf16": 0, "fft_cross_pass": 0,
            "fft_subrows": 0, "packed_power": 0, "tier_split": 0, "tier_inner": 0,
            "tier_outer": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str        # nvcc's output, including -Xptxas -v resource usage
    unit_seconds: tuple = ()  # when each unit's object was compiled, from the start


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


def library_digest() -> str:
    """The hash of ``csrc/featurizer.cu`` and of :data:`BUILD_RECIPE` that
    names the library built from them."""
    src = SOURCE.read_bytes()
    return hashlib.sha1(src + repr(sorted(BUILD_RECIPE.items())).encode()).hexdigest()[:12]


def library_path(digest: Optional[str] = None) -> Path:
    """Where :func:`build` puts (and finds) the library of ``digest``
    (default: the current source's)."""
    return BUILD_DIR / f"libsed_featurizer_{digest or library_digest()}.so"


def install_library(data: bytes, digest: str, sha256: str) -> Path:
    """Put the bytes of a library built from this source (``digest``) into
    ``_build/`` under :func:`build`'s name, unless one is there already, so
    the kernels load without ``nvcc``.  Refuses bytes of another source or
    whose sha256 is not ``sha256``.  The bytes are native code that the
    process will run: pass only a library you built."""
    if digest != library_digest():
        raise ValueError(f"kernel library {digest} was built from another "
                         f"featurizer.cu than this one ({library_digest()})")
    if hashlib.sha256(data).hexdigest() != sha256:
        raise ValueError(f"kernel library {digest}: its bytes do not match their sha256")
    path = library_path(digest)
    if not path.exists():   # a temporary file renamed, as build() writes it
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)
    return path


def build(force: bool = False) -> BuildInfo:
    """Compile ``csrc/featurizer.cu`` into ``_build/``: one object of it for
    each unit of :data:`BUILD_RECIPE`, side by side, then the shared library
    of them all.

    The library's name carries a hash of the source and the recipe
    (:func:`library_digest`), so an edited source is rebuilt and an
    unchanged one is reused unless ``force``.  The build writes a temporary
    file and renames it, so concurrent processes never load a half-written
    library.
    """
    path = library_path()
    if path.exists() and not force:
        return BuildInfo(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    units = BUILD_RECIPE["units"]
    objs = [path.with_suffix(f".{os.getpid()}.{i}.o") for i in range(len(units))]
    cmds = [[_nvcc(), *BUILD_RECIPE["compile"], unit, "-o", str(obj), str(SOURCE)]
            for unit, obj in zip(units, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]

    def finish(proc):   # its output, and when it ended
        return proc.communicate()[0], time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        logs, unit_seconds = (list(x) for x in zip(*pool.map(finish, procs)))
    failed = [(cmd, proc.returncode) for cmd, proc in zip(cmds, procs) if proc.returncode]
    if not failed:
        cmd = [_nvcc(), *BUILD_RECIPE["link"], "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append((cmd, link.returncode))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, code = failed[0]
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return BuildInfo(path, seconds, log, tuple(unit_seconds))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sed_error_string.argtypes = [i32]
    lib.sed_error_string.restype = ctypes.c_char_p
    lib.sed_wave_stft_power.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, i32,
                                        i32, i32, vp]
    lib.sed_wave_stft_power.restype = i32
    lib.sed_mel_log.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32,
                                i32, i32, vp]
    lib.sed_mel_log.restype = i32
    lib.sed_mel_plan.argtypes = [i64, i32, i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i64)]
    lib.sed_mel_plan.restype = i32
    lib.sed_frames_stft_power.argtypes = [vp, i32, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.sed_frames_stft_power.restype = i32
    lib.sed_wave_stft_mel_log.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32,
                                          i32, i32, i32, i32, i32, i32, vp]
    lib.sed_wave_stft_mel_log.restype = i32
    lib.sed_wave_packed_fft.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, i32,
                                        i32, i32, vp]
    lib.sed_wave_packed_fft.restype = i32
    lib.sed_tier_dft_power.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, vp]
    lib.sed_tier_dft_power.restype = i32
    lib.sed_tier_fused_plan.argtypes = [i32, i32, i32, i64, i32, ctypes.POINTER(i64)]
    lib.sed_tier_fused_plan.restype = i32
    lib.sed_tier_packed_fft.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32,
                                        i32, i32, i32, vp]
    lib.sed_tier_packed_fft.restype = i32
    lib.sed_fft_cross_pass.argtypes = [vp, i32, vp, vp, vp, i64, i64, i32, i32, i32, i32, vp]
    lib.sed_fft_cross_pass.restype = i32
    lib.sed_fft_subrows.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.sed_fft_subrows.restype = i32
    lib.sed_packed_power.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
    lib.sed_packed_power.restype = i32
    lib.sed_tier_gemm_plan.argtypes = [i32, i32, i32, i32, i32, i64, ctypes.POINTER(i64)]
    lib.sed_tier_gemm_plan.restype = i32
    lib.sed_tier_split.argtypes = [vp, i32, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32, i32,
                                   i32, i32, vp]
    lib.sed_tier_split.restype = i32
    lib.sed_tier_inner.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, vp]
    lib.sed_tier_inner.restype = i32
    lib.sed_tier_outer.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, vp]
    lib.sed_tier_outer.restype = i32
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


def stockham_plan(n_fft: int, extra_smem: int = 0) -> dict:
    """How the Stockham FFT kernels (K1, K3, K5, K6) run an n_fft-point frame
    on the card: ``{"log2_m", "cross", "cluster", "threads", "smem"}``: the
    sub-rows of the global cross pass (1 up to n_fft 131072; 2, 4, 8 at 2^18,
    2^19, 2^20), the CTAs of a (sub-)row's thread-block cluster (1 up to
    n_fft 32768, then 2 and 4) and each CTA's dynamic shared memory (its
    2^min(log2 m, 14) complex points plus ``extra_smem`` bytes of the
    kernel's own).  Raises ``ValueError`` for a size the kernels do not
    take."""
    if n_fft < 4 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft must be a power of two >= 4, got {n_fft}")
    if n_fft > MAX_FFT_SIZE:
        raise ValueError(
            f"n_fft {n_fft} exceeds {MAX_FFT_SIZE}, the largest n_fft the featurizer "
            f"kernels take (1.536 MHz at sed_tpu's 0.66 s frame)")
    m = n_fft // 2
    sub = min(m, _SUB_ROW_POINTS)
    points = min(sub, _CTA_FFT_POINTS)
    cross = m // sub
    plan = {"log2_m": m.bit_length() - 1, "cross": cross, "cluster": sub // points,
            "threads": max(1, points // 16), "smem": 8 * points + extra_smem}
    if plan["smem"] > _MAX_SMEM_BYTES:
        raise ValueError(f"n_fft {n_fft} does not fit the shared-memory FFT "
                         f"({plan['smem']} B of {_MAX_SMEM_BYTES})")
    return plan


def k5_extra_smem(n_fft: int, n_segments: int) -> int:
    """K5's shared memory beside its FFT's points: the power row (m + 1
    floats; a cluster CTA's 2^14 + 1), the segment sums and, in one CTA, the
    slack that a short segment's loads reach past the row; 0 above n_fft
    131072, where K5 runs K1's launches, then K2."""
    m = n_fft // 2
    if n_fft > CLUSTER_FFT_MAX:
        return 0
    if m > _CTA_FFT_POINTS:
        return 4 * (_CTA_FFT_POINTS + 1 + n_segments)
    return 4 * (m + 1 + n_segments + MEL_SEGMENT_BINS)


def _check_fft_size(n_fft: int, window: torch.Tensor, extra_smem: int = 0) -> None:
    """``extra_smem``: bytes the kernel keeps in shared memory beside the
    points of its FFT (:func:`stockham_plan`)."""
    stockham_plan(n_fft, extra_smem)
    if window.shape != (n_fft,):
        raise ValueError(f"window must be ({n_fft},), got {tuple(window.shape)}")


# ---------------------------------------------------------------------------
# K1: waveform -> one-sided STFT power
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """(n_fft/2, 2) f32 table of W_N^k = exp(-2*pi*i*k/N), from float64."""
    return torch.from_numpy(np.stack(stft_ops.unpack_twiddles(n_fft), axis=1)).to(device)


@functools.lru_cache(maxsize=8)
def _stockham_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """(n_fft/2, 2) f32 table of the inter-pass twiddles of the Stockham FFT
    (K1, K3, K5, K6) in pass order (:func:`stft_ops.stockham_twiddles`).
    Above n_fft 32768, the 2^14 entries of a cluster CTA's FFT
    (``stockham_twiddles(32768)``), then the (C, 2^14) table of the cross
    pass (:func:`stft_ops.cluster_twiddles`), C + 1 rows of 2^14 in all."""
    parts = [stft_ops.stockham_twiddles(min(n_fft, 2 * _CTA_FFT_POINTS))]
    if n_fft > 2 * _CTA_FFT_POINTS:
        parts.append(tuple(a.reshape(-1) for a in stft_ops.cluster_twiddles(n_fft)))
    table = np.concatenate([np.stack(part, axis=1) for part in parts])
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=4)
def _cross_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """The global cross pass's (R x 2^16, 2) f32 table above n_fft 131072
    (:func:`stft_ops.cross_pass_twiddles`)."""
    return torch.from_numpy(np.stack(stft_ops.cross_pass_twiddles(n_fft), axis=1)).to(device)


def _cross_fft(data: torch.Tensor, kind: int, window: torch.Tensor, rows: int,
               n_samples: int, n_frames: int, hop: int, n_fft: int, natural=None):
    """The Stockham FFT above n_fft 131072, its first two launches: the cross
    pass of ``rows`` frames (``kind``: 0 waveforms framed as K1 frames them;
    1, 2 K3's f32 or int16 rows) into R sub-rows of 2^16 points, then the
    cluster FFT of each (their C entries refuse a grid past 2^31 - 1 blocks).  Returns the (rows, m, 2) f32 scratch holding Z in
    the sub-rows' order (K1, K3), or, with ``natural`` = (Zr, Zi), writes Z
    there in natural bin order (K6) and returns None."""
    device = data.device
    log2_m = n_fft.bit_length() - 2
    log2_r = log2_m - _SUB_ROW_LOG2
    z = torch.empty((rows, n_fft // 2, 2), dtype=torch.float32, device=device)
    lib = _library()
    err = lib.sed_fft_cross_pass(data.data_ptr(), kind, window.data_ptr(),
                                 _cross_twiddles(n_fft, device).data_ptr(), z.data_ptr(), rows,
                                 n_samples, n_frames, hop, log2_m, device.index, _stream(device))
    _check_launch("fft_cross_pass", err)
    LAUNCHES["fft_cross_pass"] += 1
    re, im = (None, None) if natural is None else (t.data_ptr() for t in natural)
    err = lib.sed_fft_subrows(z.data_ptr(), _stockham_twiddles(2 * _SUB_ROW_POINTS, device)
                              .data_ptr(), re, im, rows << log2_r, log2_r,
                              int(natural is not None), device.index, _stream(device))
    _check_launch("fft_subrows", err)
    LAUNCHES["fft_subrows"] += 1
    return z if natural is None else None


def _cross_power(data: torch.Tensor, kind: int, window: torch.Tensor, out: torch.Tensor,
                 rows: int, n_samples: int, n_frames: int, hop: int, n_fft: int) -> None:
    """K1's and K3's three launches above n_fft 131072: :func:`_cross_fft`,
    then the unpack of each frame's Z to its one-sided power in ``out``."""
    z = _cross_fft(data, kind, window, rows, n_samples, n_frames, hop, n_fft)
    device = data.device
    log2_m = n_fft.bit_length() - 2
    err = _library().sed_packed_power(
        z.data_ptr(), _twiddles(n_fft, device).data_ptr(), out.data_ptr(), rows, log2_m,
        log2_m - _SUB_ROW_LOG2, device.index, _stream(device))
    _check_launch("packed_power", err)
    LAUNCHES["packed_power"] += 1


def wave_stft_power_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                          n_fft: int) -> torch.Tensor:
    """Plain version of K1: reflect-centred framing, window, torch.fft.rfft,
    re^2 + im^2.  Computes in the dtype of ``waves`` (float32 or float64)."""
    frames = stft_ops.frame_signal(waves, n_fft, hop) * window.to(waves.dtype)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def _check_waves(name: str, waves: torch.Tensor, window: torch.Tensor, hop: int,
                 n_fft: int, extra_smem: int = 0) -> int:
    """Check what the waveform kernels (K1, K5, K6) take; returns n_frames."""
    device = waves.device
    _require_cuda_f32("waves", waves, device)
    _require_cuda_f32("window", window, device)
    if waves.ndim != 2 or waves.shape[1] < 1:
        raise ValueError(f"waves must be (n_signals, samples>0), got {tuple(waves.shape)}")
    _check_fft_size(n_fft, window, extra_smem)
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    n_sig, n_samples = waves.shape
    n_frames = stft_ops.num_frames(n_samples, hop)
    if n_sig * n_frames * stockham_plan(n_fft)["cluster"] > _MAX_GRID_X:
        raise ValueError(f"{name}: {n_sig * n_frames} frames exceed one launch's grid")
    return n_frames


def _require_cpu_or_cuda(name: str, t: torch.Tensor) -> None:
    """The custom operators have CPU and CUDA kernels only (on the meta
    device their fake kernel would answer with an empty tensor)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def wave_stft_power(waves: torch.Tensor, window: torch.Tensor, hop: int,
                    n_fft: int) -> torch.Tensor:
    """(n_sig, samples) f32 -> (n_sig, 1 + samples // hop, n_fft/2 + 1) f32
    power of the centred, reflect-padded, windowed real DFT.

    CPU tensors take :func:`wave_stft_power_plain`; CUDA tensors launch K1
    (the Stockham FFT core with the power drain: it reads the pass-ordered
    twiddles and the W_N^k table).  Unlike the TPU kernel, which emits all
    n_fft bins in its (k2, k1) tile layout for a folded filterbank, this
    returns the one-sided spectrum in natural order: the same mel product,
    without Mosaic's layout.  Both go through the custom operator
    ``sed_tpu_torch::wave_stft_power``.
    """
    _require_cpu_or_cuda("wave_stft_power", waves)
    return torch.ops.sed_tpu_torch.wave_stft_power(waves, window, hop, n_fft)


@torch.library.custom_op("sed_tpu_torch::wave_stft_power", mutates_args=(),
                         device_types="cpu")
def _wave_stft_power_op(waves: torch.Tensor, window: torch.Tensor, hop: int,
                        n_fft: int) -> torch.Tensor:
    return wave_stft_power_plain(waves, window, hop, n_fft)


@_wave_stft_power_op.register_fake
def _wave_stft_power_fake(waves, window, hop, n_fft):
    return waves.new_empty((waves.shape[0], 1 + waves.shape[1] // hop, n_fft // 2 + 1))


@_wave_stft_power_op.register_kernel("cuda")
def _wave_stft_power_cuda(waves, window, hop, n_fft):
    if waves.device.type != "cuda":
        raise ValueError(f"waves is on {waves.device}, expected a CUDA device")
    device = waves.device
    n_frames = _check_waves("wave_stft_power", waves, window, hop, n_fft)
    n_sig, n_samples = waves.shape
    out = torch.empty((n_sig, n_frames, n_fft // 2 + 1), dtype=torch.float32,
                      device=device)
    if n_sig == 0:
        return out
    if n_fft > CLUSTER_FFT_MAX:
        _cross_power(waves, 0, window, out, n_sig * n_frames, n_samples, n_frames, hop, n_fft)
        return out
    err = _library().sed_wave_stft_power(
        waves.data_ptr(), window.data_ptr(), _stockham_twiddles(n_fft, device).data_ptr(),
        _twiddles(n_fft, device).data_ptr(), out.data_ptr(), n_sig, n_samples, n_frames,
        hop, n_fft.bit_length() - 2, device.index, _stream(device))
    _check_launch("wave_stft_power", err)
    LAUNCHES["wave_stft_power"] += 1
    return out


# ---------------------------------------------------------------------------
# K6: waveform -> packed complex FFT of each frame
# ---------------------------------------------------------------------------

def wave_packed_fft_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                          n_fft: int):
    """Plain version of K6: reflect-centred framing, window, pack
    z = x_even + i*x_odd, torch.fft.fft.  Returns (real, imag) in the dtype
    of ``waves`` (float32 or float64)."""
    frames = stft_ops.frame_signal(waves, n_fft, hop) * window.to(waves.dtype)
    spec = torch.fft.fft(torch.complex(frames[..., 0::2], frames[..., 1::2]), dim=-1)
    return spec.real, spec.imag


def wave_packed_fft(waves: torch.Tensor, window: torch.Tensor, hop: int,
                    n_fft: int):
    """(n_sig, samples) f32 -> (Zr, Zi), each (n_sig, 1 + samples // hop,
    n_fft/2) f32: Z = FFT_m((x_even + i*x_odd) * window) of each centred,
    reflect-padded frame, in natural bin order.

    CPU tensors take :func:`wave_packed_fft_plain`; CUDA tensors launch K6.
    ``sed_tpu`` writes the same Z in its (k2, k1) tile layout.
    """
    if waves.device.type == "cpu":
        return wave_packed_fft_plain(waves, window, hop, n_fft)
    if waves.device.type != "cuda":
        raise ValueError(f"wave_packed_fft: unsupported device {waves.device}")
    device = waves.device
    n_frames = _check_waves("wave_packed_fft", waves, window, hop, n_fft)
    n_sig, n_samples = waves.shape
    m = n_fft // 2
    zr = torch.empty((n_sig, n_frames, m), dtype=torch.float32, device=device)
    zi = torch.empty_like(zr)
    if n_sig == 0:
        return zr, zi
    if n_fft > CLUSTER_FFT_MAX:
        _cross_fft(waves, 0, window, n_sig * n_frames, n_samples, n_frames, hop, n_fft,
                   natural=(zr, zi))
        return zr, zi
    tw = _stockham_twiddles(n_fft, device)
    err = _library().sed_wave_packed_fft(
        waves.data_ptr(), window.data_ptr(), tw.data_ptr(), zr.data_ptr(),
        zi.data_ptr(), n_sig, n_samples, n_frames, hop, n_fft.bit_length() - 2,
        device.index, _stream(device))
    _check_launch("wave_packed_fft", err)
    LAUNCHES["wave_packed_fft"] += 1
    return zr, zi


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


def _pair_aligned(frames: torch.Tensor) -> torch.Tensor:
    """``frames``, or a copy of them on their device when their first element
    is not aligned to a pair of samples.  K3 reads packed point j, samples
    2j and 2j + 1 of a row, as one 8-byte (float32) or 4-byte (int16) load,
    so it needs each row's start at an even element of an aligned base; a
    contiguous view may start at any element (``flat[1:1 + n].view(...)``)."""
    if frames.data_ptr() % (2 * frames.element_size()):
        return frames.clone()
    return frames


def frames_stft_power(frames: torch.Tensor, window: torch.Tensor,
                      n_fft: int) -> torch.Tensor:
    """(rows, n_fft) f32 or int16 frames -> (rows, n_fft/2 + 1) f32 power of
    the windowed real DFT, one-sided and in natural bin order.

    CPU tensors take :func:`frames_stft_power_plain`; CUDA tensors launch K3
    (the Stockham FFT core with the power drain: it reads the pass-ordered
    twiddles and K1's W_N^k table).
    ``window`` is the f32 window of float frames; for int16 (PCM16) frames
    the wrapper scales it by 1/32768 on the card (exact: a power of two), as
    ``stft_power_pallas`` does, so de-quantization costs the kernel nothing.
    Rows whose start is not aligned to a pair of samples are copied first
    (:func:`_pair_aligned`).
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
    if rows * stockham_plan(n_fft)["cluster"] > _MAX_GRID_X:
        raise ValueError(f"{rows} rows exceed one launch's grid")
    out = torch.empty((rows, n_fft // 2 + 1), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    frames = _pair_aligned(frames)
    is_int16 = frames.dtype == torch.int16
    if is_int16:
        window = window / 32768.0
    if n_fft > CLUSTER_FFT_MAX:
        _cross_power(frames, 2 if is_int16 else 1, window, out, rows, 0, 1, 1, n_fft)
        return out
    err = _library().sed_frames_stft_power(
        frames.data_ptr(), int(is_int16), window.data_ptr(),
        _stockham_twiddles(n_fft, device).data_ptr(), _twiddles(n_fft, device).data_ptr(),
        out.data_ptr(), rows, n_fft.bit_length() - 2, device.index, _stream(device))
    _check_launch("frames_stft_power", err)
    LAUNCHES["frames_stft_power"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: power -> log-mel
# ---------------------------------------------------------------------------

# Bins of a full segment of a band (featurizer.cu kSegBins): 32 lanes x 8.
MEL_SEGMENT_BINS = 256


@dataclasses.dataclass(frozen=True)
class MelBands:
    """The filterbank as K2 and K5 read it, plus the dense form the plain
    versions use.  ``segments[i]`` = (first bin, bins, weight offset, band)
    of segment i: band b's bins cut into runs of :data:`MEL_SEGMENT_BINS`
    from its first non-zero bin, band-major (:func:`mel_segments_numpy`);
    band b owns segments ``band_first[b] .. band_first[b + 1] - 1``; ``work``
    lists the segments by last bin, the order K2's warps take them in.
    ``weights`` ends in :data:`MEL_SEGMENT_BINS` zeros: a warp loads a
    whole segment's worth of weights, a short segment's too."""

    segments: torch.Tensor    # (n_seg, 4) int32
    band_first: torch.Tensor  # (n_mels + 1,) int32
    work: torch.Tensor        # (n_seg,) int32
    weights: torch.Tensor     # (nnz + MEL_SEGMENT_BINS,) float32
    dense: torch.Tensor       # (n_bins, n_mels) float32
    span: tuple               # (first, end) of the bins any band covers

    @property
    def n_bins(self) -> int:
        return self.dense.shape[0]

    @property
    def n_mels(self) -> int:
        return self.dense.shape[1]

    @property
    def n_segments(self) -> int:
        return self.segments.shape[0]

    @property
    def nnz(self) -> int:
        return self.weights.shape[0] - MEL_SEGMENT_BINS


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


def mel_segments_numpy(lo: np.ndarray, hi: np.ndarray, offset: np.ndarray):
    """Band ranges [lo, hi) -> (segments, band_first, work) int32 arrays.

    Band b's range is cut into runs of :data:`MEL_SEGMENT_BINS` bins from
    lo[b], the last one shorter; an empty band has none.  ``segments`` is
    (n_seg, 4): first bin, bins, weight offset, band, band-major;
    ``band_first`` (n_mels + 1) the first segment of each band; ``work`` the
    segment indices sorted by their last bin (stable).  The kernels' sums
    follow this table: each segment by one warp (or in its order), each band
    as its segments' sum left to right."""
    rows, first = [], [0]
    for b, (a, e, off) in enumerate(zip(lo.tolist(), hi.tolist(), offset.tolist())):
        for s in range(a, e, MEL_SEGMENT_BINS):
            rows.append((s, min(MEL_SEGMENT_BINS, e - s), off + s - a, b))
        first.append(len(rows))
    segments = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    last = segments[:, 0] + segments[:, 1] - 1
    work = np.argsort(last, kind="stable").astype(np.int32)
    return segments, np.asarray(first, dtype=np.int32), work


def _cached_real(fn):
    """``functools.cache`` for the device tables the wrappers' callers pass
    in, except that a result made while ``torch.export`` traces (a fake
    tensor, with no data) is returned but never kept: the next eager call
    would get it."""
    cache = {}

    @functools.wraps(fn)
    def cached(*args):
        if args not in cache:
            out = fn(*args)
            t = out.dense if isinstance(out, MelBands) else out
            if isinstance(t, torch._subclasses.FakeTensor):
                return out
            cache[args] = out
        return cache[args]

    return cached


@_cached_real
def mel_bands(cfg: SpectrogramConfig, device: torch.device) -> MelBands:
    """K2's and K5's band description of ``cfg``'s filterbank (float64 cast
    to f32)."""
    # Contiguous: an exported program saves its tables whole, not as views.
    fb = np.ascontiguousarray(mel_ops.mel_filterbank(cfg, dtype=np.float32))
    lo, hi, offset, weights = mel_bands_numpy(fb)
    segments, band_first, work = mel_segments_numpy(lo, hi, offset)
    weights = np.concatenate([weights, np.zeros(MEL_SEGMENT_BINS, np.float32)])
    covered = hi > lo
    span = (int(lo[covered].min()), int(hi[covered].max())) if covered.any() else (0, 0)
    return MelBands(*(torch.from_numpy(a).to(device)
                      for a in (segments, band_first, work, weights, fb)), span=span)


@_cached_real
def stft_window(cfg: SpectrogramConfig, device: torch.device) -> torch.Tensor:
    """The padded Hann window of ``cfg`` as a f32 tensor on ``device``."""
    return torch.from_numpy(
        stft_ops.padded_window(cfg.frame_size, cfg.nfft).copy()).to(device)


def _check_bands(bands: MelBands, device: torch.device) -> None:
    for name in ("segments", "band_first", "work"):
        t = getattr(bands, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"bands.{name} must be contiguous int32 on {device}")
    _require_cuda_f32("bands.weights", bands.weights, device)


def mel_passes(mel_precision) -> int:
    """sed_tpu's ``mel_precision`` -> K2's product mode: 0 (f32) for None,
    'bf16x4' (sed_tpu's parity mel) and 'bf16x6'; 1 for 'bf16x1', 3 for
    'bf16x3'."""
    if mel_precision in (None, "bf16x4", "bf16x6"):
        return 0
    if mel_precision in ("bf16x1", "bf16x3"):
        return TIER_PASSES[mel_precision]
    raise ValueError(f"unknown mel_precision {mel_precision!r}: expected None, "
                     f"'bf16x6', 'bf16x4', 'bf16x3' or 'bf16x1'")


def mel_log_plain(power: torch.Tensor, fb: torch.Tensor, mel_precision=None) -> torch.Tensor:
    """Plain version of K2: dense ``power @ fb`` (TF32 off), clamp, 10*log10.
    Computes in the dtype of ``power`` (float32 or float64); at
    ``mel_precision`` 'bf16x1' or 'bf16x3' the product takes that tier's bf16
    chunks of both operands (:func:`tier_matmul`)."""
    passes = mel_passes(mel_precision)
    fb = fb.to(power.dtype)
    if passes:
        melp = tier_matmul(power, fb, passes)
    else:
        with full_float32():
            melp = torch.matmul(power, fb)
    return mel_ops.power_to_db(melp)


def mel_log(power: torch.Tensor, bands: MelBands, mel_precision=None) -> torch.Tensor:
    """(rows, n_bins) f32 power -> (rows, n_mels) f32 log-mel.

    CPU tensors take :func:`mel_log_plain`; CUDA tensors launch K2, which
    reads each row's band span once through shared memory and sums the
    bands by segments (:class:`MelBands`).  Any row count and any base
    alignment: rows need not start on a 16-byte boundary.  Both go through
    the custom operator ``sed_tpu_torch::mel_log``, which takes the band
    tensors and span in place of the :class:`MelBands`.  ``mel_precision``
    'bf16x1' or 'bf16x3' (:func:`mel_passes`) runs K2's bf16 product mode of
    that tier, bound directly (no operator: no exported program asks for it),
    counted under ``LAUNCHES["mel_log_bf16"]``.
    """
    _require_cpu_or_cuda("mel_log", power)
    passes = mel_passes(mel_precision)
    if passes == 0:
        return torch.ops.sed_tpu_torch.mel_log(power, bands.segments, bands.band_first,
                                               bands.work, bands.weights, bands.dense,
                                               *bands.span)
    if power.device.type == "cpu":
        return mel_log_plain(power, bands.dense, mel_precision)
    return _launch_mel_log(power, bands, passes)


@torch.library.custom_op("sed_tpu_torch::mel_log", mutates_args=(), device_types="cpu")
def _mel_log_op(power: torch.Tensor, segments: torch.Tensor, band_first: torch.Tensor,
                work: torch.Tensor, weights: torch.Tensor, dense: torch.Tensor,
                span_first: int, span_end: int) -> torch.Tensor:
    return mel_log_plain(power, dense)


@_mel_log_op.register_fake
def _mel_log_fake(power, segments, band_first, work, weights, dense, span_first, span_end):
    return power.new_empty((power.shape[0], dense.shape[1]))


@_mel_log_op.register_kernel("cuda")
def _mel_log_cuda(power, segments, band_first, work, weights, dense, span_first, span_end):
    if power.device.type != "cuda":
        raise ValueError(f"power is on {power.device}, expected a CUDA device")
    bands = MelBands(segments, band_first, work, weights, dense, (span_first, span_end))
    return _launch_mel_log(power, bands, 0)


def _launch_mel_log(power: torch.Tensor, bands: MelBands, passes: int) -> torch.Tensor:
    """K2 on a CUDA tensor at product mode ``passes`` (:func:`mel_passes`)."""
    device = power.device
    _require_cuda_f32("power", power, device)
    _check_bands(bands, device)
    if power.ndim != 2 or power.shape[1] != bands.n_bins:
        raise ValueError(f"power must be (rows, {bands.n_bins}), got {tuple(power.shape)}")
    rows = power.shape[0]
    out = torch.empty((rows, bands.n_mels), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    err = _library().sed_mel_log(
        power.data_ptr(), bands.segments.data_ptr(), bands.band_first.data_ptr(),
        bands.work.data_ptr(), bands.weights.data_ptr(), out.data_ptr(), rows,
        bands.n_bins, bands.n_mels, bands.n_segments, *bands.span, passes, device.index,
        _stream(device))
    _check_launch("mel_log", err)
    LAUNCHES["mel_log" if passes == 0 else "mel_log_bf16"] += 1   # K2 / its bf16 modes
    return out


# ---------------------------------------------------------------------------
# K5: waveform -> log-mel in one launch
# ---------------------------------------------------------------------------

def _rows_mel_log_plain(power: torch.Tensor, fb: torch.Tensor, mel_precision) -> torch.Tensor:
    """(n_sig, n_frames, n_bins) power -> log-mel by plain K2 on its rows."""
    n_sig, n_frames, n_bins = power.shape
    return mel_log_plain(power.reshape(-1, n_bins), fb, mel_precision).reshape(n_sig, n_frames, -1)


def wave_stft_mel_log_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                            n_fft: int, fb: torch.Tensor, mel_precision=None) -> torch.Tensor:
    """Plain version of K5 (K5b at a bf16 ``mel_precision``): plain K1 then
    plain K2, in the dtype of ``waves``."""
    return _rows_mel_log_plain(wave_stft_power_plain(waves, window, hop, n_fft), fb,
                               mel_precision)


def wave_stft_mel_log(waves: torch.Tensor, window: torch.Tensor, hop: int,
                      n_fft: int, bands: MelBands, mel_precision=None) -> torch.Tensor:
    """(n_sig, samples) f32 -> (n_sig, 1 + samples // hop, n_mels) f32
    log-mel: K1 then K2 in one kernel, no power array in device memory.

    CPU tensors take :func:`wave_stft_mel_log_plain`; CUDA tensors launch K5,
    or K5b at a ``mel_precision`` with bf16 passes (:func:`mel_passes`: the
    same kernel with K2's product mode in its epilogue, counted under
    ``LAUNCHES["wave_stft_mel_log_mel_bf16"]``).  Above n_fft 131072 K5 is K1's
    launches, then K2 at that mode (a frame's power does not stay on chip):
    K1 then K2 by construction, counted under those kernels' names.
    """
    passes = mel_passes(mel_precision)
    if waves.device.type == "cpu":
        return wave_stft_mel_log_plain(waves, window, hop, n_fft, bands.dense, mel_precision)
    if waves.device.type != "cuda":
        raise ValueError(f"wave_stft_mel_log: unsupported device {waves.device}")
    device = waves.device
    n_frames = _check_waves("wave_stft_mel_log", waves, window, hop, n_fft,
                            extra_smem=k5_extra_smem(n_fft, bands.n_segments))
    _check_bands(bands, device)
    if bands.n_bins != n_fft // 2 + 1:
        raise ValueError(f"bands cover {bands.n_bins} bins, n_fft {n_fft} has "
                         f"{n_fft // 2 + 1}")
    n_sig, n_samples = waves.shape
    out = torch.empty((n_sig, n_frames, bands.n_mels), dtype=torch.float32,
                      device=device)
    if n_sig == 0:
        return out
    name = "wave_stft_mel_log" if passes == 0 else "wave_stft_mel_log_mel_bf16"
    if n_fft > CLUSTER_FFT_MAX:
        power = torch.empty((n_sig * n_frames, n_fft // 2 + 1), dtype=torch.float32,
                            device=device)
        _cross_power(waves, 0, window, power, n_sig * n_frames, n_samples, n_frames, hop, n_fft)
        return _launch_mel_log(power, bands, passes).reshape(n_sig, n_frames, -1)
    err = _library().sed_wave_stft_mel_log(
        waves.data_ptr(), window.data_ptr(), _stockham_twiddles(n_fft, device).data_ptr(),
        _twiddles(n_fft, device).data_ptr(), bands.segments.data_ptr(),
        bands.band_first.data_ptr(), bands.weights.data_ptr(), out.data_ptr(), n_sig,
        n_samples, n_frames, hop, n_fft.bit_length() - 2, bands.n_mels,
        bands.n_segments, passes, device.index, _stream(device))
    _check_launch("wave_stft_mel_log", err)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K1t, K3t: the reduced-precision tiers' bf16 tensor-core DFT
# ---------------------------------------------------------------------------

# sed_tpu's raw precision strings of its matmul DFT (_make_dot) and the bf16
# passes each product takes.
TIER_PASSES = {"bf16x1": 1, "bf16x3": 3, "bf16x4": 4, "bf16x6": 6}
# Every (inner, outer) pass count of the tiers.
_EVERY_PASSES = tuple((a, b) for a in TIER_PASSES.values() for b in TIER_PASSES.values())
# The (chunk of a, chunk of b) product terms of a tier, in _make_dot's order:
# a tier of P passes sums the first P.
_TIER_TERMS = ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (0, 2))
# log2 n_fft where K1t and K3t (and K5t, K1t's route then K2) ask the
# library's plan (:func:`fused_plan`) whether the fused kernel takes the size
# (n1 = 2^(log2 n // 2) >= 32, n2 >= 64, n1 <= 256; the library answers per
# size and passes), and of K6t's
# one-launch instances (tier_packed_fft_kernel, m = n_fft/2 points).
TIER_LOG2_N = range(11, 18)
PACKED_TIER_LOG2_N = range(12, 18)
# Every log2 n_fft each tier kernel takes on the card: from the smallest
# sed_tpu computes at a reduced tier ('roll' and the tick 128, 'pack' 256:
# its TPU kernels need 128 lanes of a frame or of its m packed points;
# 'fuse' 2048, its TILE_K) up to MAX_FFT_SIZE.  Where the fused kernel does not
# take a size and passes (:func:`tier_route`) K1t and K3t run the tier GEMMs
# (:data:`GEMM_KERNELS`); K5t runs K1t's launches, then K2; K6t runs the
# GEMMs outside its instances' sizes.
TIER_RANGES = {"wave_dft_power_bf16": range(7, 21), "frames_dft_power_bf16": range(7, 21),
               "wave_stft_mel_log_bf16": range(11, 21), "wave_packed_fft_bf16": range(8, 21)}


def _stage_passes(p) -> int:
    if p is None:
        return 6  # Precision.HIGHEST: sed_tpu records bf16x6 equal to it
    if isinstance(p, str) and p in TIER_PASSES:
        return TIER_PASSES[p]
    raise ValueError(f"unknown featurizer precision {p!r}: expected None, "
                     f"{', '.join(map(repr, TIER_PASSES))} or an (inner, outer) "
                     f"pair of them")


def tier_passes(precision):
    """sed_tpu's ``precision`` of its FFT -> None (the parity tier: K1, K3)
    or the (inner, outer) bf16 passes of the two DFT stages: 'bf16x1',
    'bf16x3', 'bf16x4' or 'bf16x6' for both, or an ``(inner, outer)`` pair
    of those, in which None (sed_tpu's HIGHEST) is 6 passes."""
    if precision is None:
        return None
    if isinstance(precision, (tuple, list)):
        if len(precision) != 2:
            raise ValueError(f"a per-stage precision is an (inner, outer) pair, got "
                             f"{precision!r}")
        return tuple(_stage_passes(p) for p in precision)
    if precision not in TIER_PASSES:
        raise ValueError(f"unknown featurizer precision {precision!r}: expected None, "
                         f"{', '.join(map(repr, TIER_PASSES))} or an (inner, outer) "
                         f"pair of them")
    return (TIER_PASSES[precision],) * 2


def _tier_chunks(passes: int) -> int:
    return 1 if passes == 1 else 3 if passes == 6 else 2


def split_bf16(a: torch.Tensor, chunks: int) -> list:
    """``a`` -> ``chunks`` bf16-valued tensors of its dtype whose sum is
    ``a`` to the last chunk's rounding: c0 = bf16(a), c1 = bf16(a - c0), ...
    by round to nearest even (sed_tpu's ``_split_bf16``, its ``_split3`` for
    three, with each chunk rounded to bf16 as the TPU's matrix unit rounds
    an operand)."""
    out = []
    for _ in range(chunks):
        c = a.to(torch.bfloat16).to(a.dtype)
        out.append(c)
        a = a - c
    return out


def tier_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` at sed_tpu's ``_make_dot`` tier of ``passes`` (1, 3, 4, 6):
    the products of the operands' bf16 chunks, each summed in float64 (the
    products are exact) and rounded once to the operands' dtype, as an exact
    accumulator would give them, then added in that dtype in ``_make_dot``'s
    order.  Float64 sums make the result independent of how a library blocks
    the sum (a float32 one differs by an ulp between batch shapes, which
    moves a bf16 rounding of the next stage)."""
    n = _tier_chunks(passes)
    ca, cb = split_bf16(a, n), split_bf16(b, n)
    out = None
    for i, j in _TIER_TERMS[:passes]:
        d = torch.matmul(ca[i].double(), cb[j].double()).to(a.dtype)
        out = d if out is None else out + d
    return out


@functools.lru_cache(maxsize=8)
def _tier_constants(n_fft: int, device: torch.device):
    """sed_tpu's f32 matmul-FFT constants (``_matmul_fft_constants``) on
    ``device``: n1, n2, W2 (re, im), W1 (re, im), twiddles (re, im)."""
    n1, n2, w2, w1, tw = stft_ops._matmul_fft_constants(n_fft)
    return (n1, n2, *(tuple(torch.from_numpy(c).to(device) for c in pair)
                      for pair in (w2, w1, tw)))


def _tier_packed_plain(x: torch.Tensor, n_fft: int, passes):
    """(..., n_fft) windowed f32 frames -> (Zr, Zi), each (..., m = n_fft/2):
    sed_tpu's packed matmul DFT (``_make_wave_packed_fft_kernel``) of z =
    x_even + i*x_odd at (inner, outer) ``passes``, step by step at its
    rounding points from its m-point constants (``_packed_fft_constants``):
    Yr = W2r @ Xr - W2i @ Xi, Yi = W2r @ Xi + W2i @ Xr, T = Y * tw (f32),
    Zr = Tr @ W1r - Ti @ W1i, Zi = Tr @ W1i + Ti @ W1r, bin n2*k1 + k2 in
    natural order."""
    inner, outer = passes
    n1, n2, (w2r, w2i), (w1r, w1i), (twr, twi) = _tier_constants(n_fft // 2, x.device)
    lead = x.shape[:-1]
    xr, xi = (x[..., h::2].reshape(*lead, n2, n1) for h in (0, 1))
    yr = tier_matmul(w2r, xr, inner) - tier_matmul(w2i, xi, inner)
    yi = tier_matmul(w2r, xi, inner) + tier_matmul(w2i, xr, inner)
    tr = yr * twr - yi * twi
    ti = yr * twi + yi * twr
    zr = tier_matmul(tr, w1r, outer) - tier_matmul(ti, w1i, outer)
    zi = tier_matmul(tr, w1i, outer) + tier_matmul(ti, w1r, outer)
    return tuple(z.transpose(-1, -2).reshape(*lead, n1 * n2).contiguous() for z in (zr, zi))


def _tier_power_plain(x: torch.Tensor, n_fft: int, passes) -> torch.Tensor:
    """(..., n_fft) windowed f32 frames -> (..., n_fft/2 + 1) one-sided power
    by sed_tpu's two-stage matmul DFT at (inner, outer) ``passes``, step by
    step at its rounding points: Y = W2 @ X, T = Y * tw (f32, yr*twr - yi*twi),
    Z = T @ W1 as dot(tr, w1r) - dot(ti, w1i), |Z|^2, bin n2*k1 + k2; only
    the columns k1 <= n1/2 of the outer stage, which hold the one-sided bins.
    Its two stages are :func:`_tier_inner_plain` and :func:`_tier_outer_plain`
    (the plain versions of the tier GEMMs' two stages)."""
    inner, outer = passes
    return _tier_outer_plain(*_tier_inner_plain(x, n_fft, inner), n_fft, outer)


def _tier_inner_plain(x: torch.Tensor, n_fft: int, inner: int):
    """Stage 1 of :func:`_tier_power_plain`: (..., n_fft) windowed frames ->
    (Tr, Ti), each (..., n2, n1) f32."""
    n1, n2, (w2r, w2i), _, (twr, twi) = _tier_constants(n_fft, x.device)
    x = x.reshape(*x.shape[:-1], n2, n1)
    yr, yi = tier_matmul(w2r, x, inner), tier_matmul(w2i, x, inner)
    return yr * twr - yi * twi, yr * twi + yi * twr


def _tier_outer_plain(tr: torch.Tensor, ti: torch.Tensor, n_fft: int, outer: int):
    """Stage 2 of :func:`_tier_power_plain`: (Tr, Ti) -> one-sided power."""
    n1, n2, _, (w1r, w1i), _ = _tier_constants(n_fft, tr.device)
    h = n1 // 2 + 1
    w1r, w1i = w1r[:, :h], w1i[:, :h]
    zr = tier_matmul(tr, w1r, outer) - tier_matmul(ti, w1i, outer)
    zi = tier_matmul(tr, w1i, outer) + tier_matmul(ti, w1r, outer)
    power = zr * zr + zi * zi                          # (..., k2, k1)
    lead = tr.shape[:-2]
    return power.transpose(-1, -2).reshape(*lead, h * n2)[..., : n_fft // 2 + 1].contiguous()


def wave_dft_power_bf16_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                              n_fft: int, precision) -> torch.Tensor:
    """Plain version of K1t: K1's reflect-centred framing and window, then
    :func:`_tier_power_plain` at ``precision`` (:func:`tier_passes`)."""
    frames = stft_ops.frame_signal(waves.to(torch.float32), n_fft, hop) * window
    return _tier_power_plain(frames, n_fft, _reduced_passes(precision))


def wave_stft_mel_log_bf16_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                                 n_fft: int, fb: torch.Tensor, precision,
                                 mel_precision=None) -> torch.Tensor:
    """Plain version of K5t: plain K1t at ``precision``, then plain K2 at
    ``mel_precision`` on its rows."""
    return _rows_mel_log_plain(wave_dft_power_bf16_plain(waves, window, hop, n_fft, precision),
                               fb, mel_precision)


def wave_packed_fft_bf16_plain(waves: torch.Tensor, window: torch.Tensor, hop: int,
                               n_fft: int, precision):
    """Plain version of K6t: K6's reflect-centred framing and window, then
    :func:`_tier_packed_plain` at ``precision``; (Zr, Zi), each (n_sig,
    n_frames, n_fft/2) f32."""
    frames = stft_ops.frame_signal(waves.to(torch.float32), n_fft, hop) * window
    return _tier_packed_plain(frames, n_fft, _reduced_passes(precision))


def frames_dft_power_bf16_plain(frames: torch.Tensor, window: torch.Tensor, n_fft: int,
                                precision) -> torch.Tensor:
    """Plain version of K3t: rows times the window (int16 rows are PCM16: the
    window scaled by 1/32768, as K3), then :func:`_tier_power_plain`."""
    if frames.shape[-1] != n_fft:
        raise ValueError(f"frames must be (rows, {n_fft}), got {tuple(frames.shape)}")
    w = window.to(torch.float32)
    if frames.dtype == torch.int16:
        w = w / 32768.0
    return _tier_power_plain(frames.to(torch.float32) * w, n_fft, _reduced_passes(precision))


def mode_fraction(got: torch.Tensor, want: torch.Tensor, neighbour: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> float:
    """How far ``got`` (a kernel's output) lies from ``want`` (the plain
    version at its mode) towards ``neighbour`` (the plain version at the
    mode next to it), along the line between them: 0 at its own mode, 1 at
    the neighbour's.  The noise of the kernel's float32 sums is not
    correlated with the gap between the modes, so this tells apart modes
    whose gap is below that noise at any one element (bf16x3 from bf16x4).
    ``scale``: divides both differences, e.g. each frame's peak power."""
    e, d = got.double() - want.double(), neighbour.double() - want.double()
    if scale is not None:
        e, d = e / scale, d / scale
    return float((e * d).sum() / (d * d).sum())


def _reduced_passes(precision):
    passes = tier_passes(precision)
    if passes is None:
        raise ValueError("the bf16 tier DFT takes a reduced precision; None is the "
                         "parity tier (K1, K3)")
    return passes


def mel_plan(n_segments: int, n_mels: int, rows: int = 1 << 40,
             device: Optional[torch.device] = None) -> Optional[dict]:
    """K2's plan for ``rows`` rows (default: more than every SM's group) of
    ``n_segments`` segments and ``n_mels`` bands, as the kernel library
    launches it on ``device`` (default: the current card): ``{"rows_at_once",
    "smem"}``, the rows a CTA sums at once and its dynamic shared memory
    (featurizer.cu ``sed_mel_plan``).  None where no card is present: the
    library decides both at launch, and a CPU tensor never launches it."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    r, smem = ctypes.c_int(), ctypes.c_longlong()
    err = _library().sed_mel_plan(rows, n_segments, n_mels, device.index, ctypes.byref(r),
                                  ctypes.byref(smem))
    _check_launch("mel_plan", err)
    return {"rows_at_once": r.value, "smem": smem.value}


def launch_plan(n_fft: int, n_segments: int = 0, n_mels: int = 64, passes=None) -> dict:
    """What each featurizer kernel launches at n_fft on the card, by its
    :data:`LAUNCHES` name: ``{"route", "kernels", "instance", "cluster",
    "smem"}``.  ``route``: 'one' (one launch of its instance), 'cross' (K1,
    K3, K6 above n_fft 131072: the cross pass, the sub-rows' cluster FFT and,
    K1 and K3, the unpack), 'fused' (K1t, K3t where the library's
    :func:`fused_plan` takes the size: the split pass, then
    ``tier_fused_kernel``), 'gemm' (the tier GEMMs: the split pass and two
    stages, :data:`GEMM_KERNELS`) or 'chain' (K5 above 131072, K5t: the
    power kernel's launches, then K2); ``kernels``: the :data:`LAUNCHES`
    names a call adds one to (its own name on route 'one', its kernels'
    names on the others, each with an entry of its own but the fused
    kernel's, counted under the calling wrapper's name; the tier GEMMs' and
    the fused route's once a frame group, :func:`gemm_plan`,
    :func:`fused_plan`); ``instance`` the template instance(s), ``cluster``
    the CTAs of a frame's (sub-row's) thread-block cluster (1: none) and
    ``smem`` the largest dynamic shared memory of a CTA (the tier kernels:
    over their pass counts; K5 with ``n_segments`` segment sums of
    ``n_mels`` bands; 0 for the kernels with static shared memory only: the
    cross pass, the unpack and the tier GEMMs' split pass).  ``passes``: the
    tier kernels' (inner, outer) passes, which the library's choice of
    route at :data:`TIER_LOG2_N` may depend on (None: every pass count).
    K2's rows at once and shared memory, the tier GEMMs' stages' shared
    memory and, at :data:`TIER_LOG2_N`, K1t's, K3t's and K5t's route and
    all of their entry are the library's (:func:`mel_plan`,
    :func:`gemm_plan`, :func:`fused_plan`), so where no card is present, or
    where the pass counts take different routes and ``passes`` is None,
    those entries (every key of the last) and the chains' ``smem`` are None.
    Every kernel appears at each n_fft of its range (4..MAX_FFT_SIZE; the
    tier kernels :data:`TIER_RANGES`), and an n_fft above MAX_FFT_SIZE
    raises ``ValueError`` as the wrappers do.  The wrappers' size checks
    read the same functions (:func:`stockham_plan`, :func:`tier_route`)."""
    sp = stockham_plan(n_fft)
    log2_n = n_fft.bit_length() - 1
    plan = {}

    def entry(route, kernels, instance, cluster, smem):
        return {"route": route, "kernels": kernels, "instance": instance, "cluster": cluster,
                "smem": smem}

    def chain(route, parts):
        smem = [plan[k]["smem"] for k in parts]
        return entry(route, parts, " + ".join(plan[k]["instance"] for k in parts),
                     max(plan[k]["cluster"] for k in parts), None if None in smem else max(smem))

    mel = mel_plan(n_segments, n_mels)
    plan["mel_log"] = entry("one", ("mel_log",), "mel_log_kernel<%s, kPasses>" % (
        "R" if mel is None else mel["rows_at_once"]), 1, mel and mel["smem"])
    cross = sp["cross"] > 1
    if cross:
        sub = stockham_plan(2 * _SUB_ROW_POINTS)
        plan["fft_cross_pass"] = entry("one", ("fft_cross_pass",),
                                       f"fft_cross_pass_kernel<{sp['cross']}>", 1, 0)
        plan["fft_subrows"] = entry("one", ("fft_subrows",), "fft_subrows_kernel<kNatural>",
                                    sub["cluster"], sub["smem"])
        plan["packed_power"] = entry("one", ("packed_power",), "packed_power_kernel", 1, 0)
    for name, kernel in (("wave_stft_power", "wave_stft_power_kernel"),
                         ("frames_stft_power", "frames_stft_power_kernel"),
                         ("wave_packed_fft", "wave_packed_fft_kernel"),
                         ("wave_stft_mel_log", "wave_stft_mel_log_kernel")):
        if not cross:
            extra = k5_extra_smem(n_fft, n_segments) if name == "wave_stft_mel_log" else 0
            p = stockham_plan(n_fft, extra)
            plan[name] = entry("one", (name,), f"{kernel}<{p['log2_m']}>", p["cluster"],
                               p["smem"])
            continue
        parts = ("fft_cross_pass", "fft_subrows") + (
            () if name == "wave_packed_fft" else ("packed_power",))
        if name == "wave_stft_mel_log":
            parts += ("mel_log",)
        plan[name] = chain("chain" if name == "wave_stft_mel_log" else "cross", parts)
    every = [passes] if passes else _EVERY_PASSES
    for name in TIER_RANGES:
        if log2_n not in TIER_RANGES[name]:
            continue
        route = tier_route(name, n_fft, passes)
        if route == "one":
            n1 = 1 << ((log2_n - 1) // 2)
            plan[name] = entry(route, (name,), f"tier_packed_fft_kernel<{n1}, P1, P2>", 1,
                               max(packed_plan(n1, a, b)["smem"] for a, b in every))
        elif route is None:   # the library's choice, without a card or by pass count
            plan[name] = entry(None, None, None, None, None)
        elif route == "fused":
            fused = [fused_plan(n_fft, p, 1) for p in every]
            plan["tier_split"] = entry("one", ("tier_split",), "tier_split_kernel<C1, kPacked>",
                                       1, 0)
            plan[name] = entry(route, ("tier_split", name),
                               f"tier_split_kernel<C1, kPacked> + tier_fused_kernel<P1, P2, "
                               f"{1 << (log2_n // 2)}>", 1, max(f["smem"] for f in fused))
        elif name == "wave_stft_mel_log_bf16":   # K1t's route, then K2
            k1t = plan["wave_dft_power_bf16"]
            parts = tuple(name if k == "wave_dft_power_bf16" else k for k in k1t["kernels"])
            smem = [k1t["smem"], plan["mel_log"]["smem"]]
            plan[name] = entry(route, parts + ("mel_log",),
                               k1t["instance"] + " + " + plan["mel_log"]["instance"], 1,
                               None if None in smem else max(smem))
        else:
            n = n_fft // 2 if name == "wave_packed_fft_bf16" else n_fft
            stages = [gemm_plan(n, name == "wave_packed_fft_bf16", p, 1) for p in every]
            smem = {k: None if None in stages else max(s[k] for s in stages)
                    for k in ("smem_inner", "smem_outer")}
            plan["tier_split"] = entry("one", ("tier_split",), "tier_split_kernel<C1, kPacked>",
                                       1, 0)
            plan["tier_inner"] = entry("one", ("tier_inner",), "tier_inner_kernel<P1, C2>", 1,
                                       smem["smem_inner"])
            plan["tier_outer"] = entry("one", ("tier_outer",), "tier_outer_kernel<P2, kPacked>",
                                       1, smem["smem_outer"])
            plan[name] = chain(route, GEMM_KERNELS)
    return plan


def tier_route(name: str, n_fft: int, passes=None) -> Optional[str]:
    """How tier kernel ``name`` (a :data:`TIER_RANGES` key) runs n_fft on the
    card at (inner, outer) ``passes`` (None: every pass count): 'one' (K6t's
    instance), 'fused' (K1t, K3t: the split pass, then
    ``tier_fused_kernel``), 'gemm' (the tier GEMMs, :data:`GEMM_KERNELS`)
    or 'chain' (K5t: K1t's route, then K2).  At :data:`TIER_LOG2_N` K1t and
    K3t take the library's choice (:func:`fused_plan`), and K5t follows
    them: None where no card is present, or where the pass counts take
    different routes and ``passes`` is None.  Raises ``ValueError``, naming
    the range, for a size it does not take."""
    sizes = TIER_RANGES[name]
    log2_n = n_fft.bit_length() - 1
    if n_fft < 1 or n_fft & (n_fft - 1) or log2_n not in sizes:
        what = {"wave_packed_fft_bf16": "packed ", "wave_stft_mel_log_bf16": "fused "}.get(name, "")
        raise ValueError(f"the {what}bf16 tier DFT takes n_fft a power of two from "
                         f"{2 ** sizes[0]} to {2 ** sizes[-1]}, got {n_fft}")
    if name == "wave_packed_fft_bf16":
        return "one" if log2_n in PACKED_TIER_LOG2_N else "gemm"
    if name == "wave_stft_mel_log_bf16":
        return "chain" if tier_route("wave_dft_power_bf16", n_fft, passes) else None
    if log2_n not in TIER_LOG2_N:
        return "gemm"
    plans = [fused_plan(n_fft, p, 1) for p in ([passes] if passes else _EVERY_PASSES)]
    if None in plans:
        return None
    routes = {"fused" if p["fused"] else "gemm" for p in plans}
    return routes.pop() if len(routes) == 1 else None


def _check_tier_size(name: str, n_fft: int, window: torch.Tensor, passes) -> str:
    """:func:`tier_route` of ``name`` at n_fft and ``passes``, and the
    window's shape."""
    route = tier_route(name, n_fft, passes)
    if window.shape != (n_fft,):
        raise ValueError(f"window must be ({n_fft},), got {tuple(window.shape)}")
    return route


# The tier GEMMs' launches, once a frame group each: the split pass, stage 1,
# stage 2 (featurizer.cu tier_split_kernel, tier_inner_kernel,
# tier_outer_kernel).
GEMM_KERNELS = ("tier_split", "tier_inner", "tier_outer")
_GEMM_PLAN_KEYS = ("group_frames", "scratch_bytes", "x_bytes", "tab1_rows", "tab2_rows",
                   "smem_inner", "smem_outer")


def gemm_plan(n: int, packed: bool, passes, frames: int) -> Optional[dict]:
    """The tier GEMMs over ``frames`` frames of an n-point DFT (K6t: n = m
    packed points) at (inner, outer) ``passes`` as the kernel library
    launches them (its ``sed_tier_gemm_plan``): ``group_frames`` (the frames
    a group of launches takes, its planes within the library's scratch
    budget), ``scratch_bytes`` (a group's X and T planes), ``x_bytes`` (X's
    part, T's offset), ``tab1_rows`` and ``tab2_rows`` (the tables' rows
    with the tiles' padding) and each stage's ``smem_inner``, ``smem_outer``.
    None where no card is present: the library decides all of them, and a
    CPU tensor never launches the GEMMs."""
    if not torch.cuda.is_available():
        return None
    inner, outer = passes
    return _gemm_plan(*_gemm_dims(n), int(packed), inner, outer, frames)


@functools.lru_cache(maxsize=64)
def _gemm_plan(log2_n1: int, log2_n2: int, packed: int, inner: int, outer: int,
               frames: int) -> dict:
    values = (ctypes.c_longlong * len(_GEMM_PLAN_KEYS))()
    err = _library().sed_tier_gemm_plan(log2_n1, log2_n2, packed, inner, outer, frames, values)
    _check_launch("tier_gemm_plan", err)
    return dict(zip(_GEMM_PLAN_KEYS, values))


def frame_groups(frames: int, group_frames: int) -> list:
    """(first frame, frames) of each group of launches of the tier GEMMs over
    ``frames`` frames, ``group_frames`` a group (:func:`gemm_plan`)."""
    return [(r, min(group_frames, frames - r)) for r in range(0, frames, group_frames)]


# K1t's and K3t's fused route (featurizer.cu sed_tier_fused_plan): whether
# it takes the size, then, where the kernel's shape fits, its frame group,
# the group's X planes, the tables' rows, threads, shared memory, k2 rows a
# unit, stage 1's columns a pass, ring slots and CTAs.
_FUSED_PLAN_KEYS = ("fused", "group_frames", "x_bytes", "tab1_rows", "tab2_rows", "threads",
                    "smem", "unit_rows", "np", "slots", "ctas")


def fused_plan(n_fft: int, passes, frames: int,
               device: Optional[torch.device] = None) -> Optional[dict]:
    """K1t's and K3t's plan at n_fft (a :data:`TIER_LOG2_N` size) and (inner,
    outer) ``passes`` over ``frames`` frames, as the kernel library launches
    them on ``device`` (default: the current card; its
    ``sed_tier_fused_plan``): ``fused`` (True where the split pass and
    ``tier_fused_kernel`` run the size; False where the tier GEMMs do), and
    where the kernel's shape fits (``np`` non-zero, whichever the route)
    ``group_frames`` (the frames a group of launches takes, its X planes
    within the library's scratch budget), ``x_bytes`` (a group's X planes),
    ``tab1_rows`` and ``tab2_rows`` (the tier GEMMs' tables), ``threads``,
    ``smem`` (dynamic shared memory), ``unit_rows`` (k2 rows a unit),
    ``np`` (stage 1's columns a pass), ``slots`` (the ring's) and ``ctas``
    (the grid over a group).  None where no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    inner, outer = passes
    return _fused_plan(n_fft.bit_length() - 1, inner, outer, frames, device.index)


@functools.lru_cache(maxsize=256)
def _fused_plan(log2_n: int, inner: int, outer: int, frames: int, device: int) -> dict:
    values = (ctypes.c_longlong * len(_FUSED_PLAN_KEYS))()
    err = _library().sed_tier_fused_plan(log2_n, inner, outer, frames, device, values)
    _check_launch("tier_fused_plan", err)
    plan = dict(zip(_FUSED_PLAN_KEYS, values))
    plan["fused"] = bool(plan["fused"])
    return plan


def plane_image(a: np.ndarray, chunks: int, rows: int) -> torch.Tensor:
    """The tier GEMMs' plane of (r, k) f32 ``a``, r <= ``rows``: its
    ``chunks`` bf16 chunks (:func:`split_bf16`), each in K tiles of 64 k,
    each tile ``rows`` rows of 64 under the 128-byte swizzle (featurizer.cu
    ``plane_byte``: element (c, r, k) at ((c kt + k // 64) rows + r) 128 +
    the swizzled place of k % 64 in the row); rows past r and k past a's
    zero.  A flat bf16 tensor on the CPU."""
    r, k = a.shape
    kt = -(-k // 64)
    full = np.zeros((rows, kt * 64), np.float32)
    full[:r, :k] = a
    parts = np.stack([c.numpy() for c in split_bf16(torch.from_numpy(full), chunks)])
    tiles = parts.reshape(chunks, rows, kt, 64).transpose(0, 2, 1, 3)
    flat = np.ascontiguousarray(sw128_image(tiles)).reshape(-1)
    return torch.from_numpy(flat).to(torch.bfloat16)


def plane_values(planes: torch.Tensor, chunks: int, rows: int, k: int, row0: int,
                 n_rows: int) -> torch.Tensor:
    """(chunks, n_rows, k) bf16: rows row0 .. row0 + n_rows - 1 of a plane of
    ``rows`` rows and k columns a chunk (:func:`plane_image`'s layout), read
    from ``planes``, its flat bf16 values or bytes (a group's X or T planes
    on the card), on their device."""
    flat = planes.view(torch.bfloat16) if planes.dtype == torch.uint8 else planes
    kt = -(-k // 64)
    r = torch.arange(row0, row0 + n_rows, device=flat.device)[:, None]
    kk = torch.arange(k, device=flat.device)[None, :]
    c = torch.arange(chunks, device=flat.device)[:, None, None]
    return flat[((c * kt + kk // 64) * rows + r) * 64 + ((kk % 64 // 8) ^ (r % 8)) * 8 + kk % 8]


def gemm_operands(n: int, packed: bool):
    """The tier GEMMs' f32 tables of an n-point DFT (K6t: n = m packed
    points; n1 = 2^(log2 n // 2)), from sed_tpu's constants
    (``_matmul_fft_constants``):
      * W (2 n2, k1): row 16t + 8h + i the coefficients of part h (0 real,
        1 imaginary) of Y at k2 = 8t + i over stage 1's k: a (X[a][b] =
        x[a n1 + b]), W2r and W2i; packed, a over Re z and n2 + a over Im z,
        W2r and -W2i for Yr, W2i and W2r for Yi;
      * V (2 c, 2 n1): row 2 k1 + h the coefficients of Zr (h = 0) or Zi
        over [Tr | Ti]: W1r and -W1i, W1i and W1r, at k1 < c = n1/2 + 4 (K1t,
        K3t: the one-sided bins and bin n/2) or every k1 (K6t, c = n1);
      * the (n2, n1) twiddles as (re, im) pairs."""
    n1, n2, (w2r, w2i), (w1r, w1i), (twr, twi) = stft_ops._matmul_fft_constants(n)
    if packed:
        parts = [np.concatenate(pair, axis=1) for pair in ((w2r, -w2i), (w2i, w2r))]
    else:
        parts = [w2r, w2i]
    k = parts[0].shape[1]
    w = np.stack([p.reshape(n2 // 8, 8, k) for p in parts], axis=1).reshape(2 * n2, k)
    j = np.arange(n1 if packed else n1 // 2 + 4)
    v = np.empty((2 * len(j), 2 * n1), np.float32)
    v[0::2, :n1], v[0::2, n1:] = w1r[:, j].T, -w1i[:, j].T
    v[1::2, :n1], v[1::2, n1:] = w1i[:, j].T, w1r[:, j].T
    return w.astype(np.float32), v, np.stack([twr, twi], axis=-1)


@functools.lru_cache(maxsize=8)
def _gemm_images(n: int, packed: bool, c1: int, c2: int, tab1_rows: int, tab2_rows: int,
                 device: torch.device):
    """The tier GEMMs' tables on ``device``: :func:`gemm_operands`' W and V
    as ``c1`` and ``c2`` chunk planes of ``tab1_rows`` and ``tab2_rows`` rows
    (:func:`plane_image`; the rows :func:`gemm_plan` gives), and the
    twiddles."""
    w, v, tw = gemm_operands(n, packed)
    return (plane_image(w, c1, tab1_rows).to(device), plane_image(v, c2, tab2_rows).to(device),
            torch.from_numpy(tw).to(device))


def _gemm_dims(n: int):
    """(log2 n1, log2 n2) of sed_tpu's n-point matmul DFT, n1 = 2^(log2 n // 2)."""
    log2_n = n.bit_length() - 1
    return log2_n // 2, log2_n - log2_n // 2


def _tier_gemm(data: torch.Tensor, kind: int, window: torch.Tensor, out: torch.Tensor,
               out_im: Optional[torch.Tensor], rows: int, n_samples: int, n_frames: int,
               hop: int, n: int, passes) -> None:
    """The tier GEMMs over ``rows`` frames of an n-point DFT at (inner,
    outer) ``passes``, a frame group at a time (:func:`gemm_plan`): the split
    pass to the group's X planes, stage 1 to its T planes, stage 2 to
    ``out``, K1t's and K3t's one-sided power (``out_im`` None; ``kind`` as
    K1t's and K3t's), or K6t's (Zr, Zi) in ``out`` and ``out_im`` (n = m,
    the packed points of waveforms).  Their C entries refuse a grid past
    2^31 - 1 blocks."""
    device = data.device
    packed = out_im is not None
    inner, outer = passes
    plan = gemm_plan(n, packed, passes, rows)
    tab1, tab2, tw = _gemm_images(n, packed, _tier_chunks(inner), _tier_chunks(outer),
                                  plan["tab1_rows"], plan["tab2_rows"], device)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=device)
    x = scratch.data_ptr()
    t = x + plan["x_bytes"]
    row_bytes = 4 * (n if packed else n // 2 + 1)
    shape = (*_gemm_dims(n), int(packed), inner, outer)
    lib, stream = _library(), _stream(device)
    for row0, g in frame_groups(rows, plan["group_frames"]):
        err = lib.sed_tier_split(data.data_ptr(), kind, window.data_ptr(), x, row0, g, n_samples,
                                 n_frames, hop, *shape, device.index, stream)
        _check_launch("tier_split", err)
        LAUNCHES["tier_split"] += 1
        err = lib.sed_tier_inner(x, tab1.data_ptr(), tw.data_ptr(), t, g, *shape, device.index,
                                 stream)
        _check_launch("tier_inner", err)
        LAUNCHES["tier_inner"] += 1
        err = lib.sed_tier_outer(t, tab2.data_ptr(), out.data_ptr() + row0 * row_bytes,
                                 out_im.data_ptr() + row0 * row_bytes if packed else None, g,
                                 *shape, device.index, stream)
        _check_launch("tier_outer", err)
        LAUNCHES["tier_outer"] += 1


# K6t (featurizer.cu tier_packed_fft_kernel): stage 2's ring of W1 tiles, and the
# 128-byte swizzle of its shared-memory tiles (rows of 64 bf16).
_PACKED_RING2 = 2


def packed_plan(n1: int, inner_passes: int, outer_passes: int) -> dict:
    """K6t's shape at n1 and the two stages' passes, as featurizer.cu's
    ``packed_shape`` computes it: ``kb`` k2 rows a unit, ``n1p`` stage-1
    columns a pass, ``d1`` stage-1 ring slots and ``smem``, the dynamic
    shared memory (T^T, the two rings, the drain, the barriers and 1024 bytes
    of alignment): the largest kb (64 up to n1 128, else 32), then n1p (up
    to 128), then d1 (3 or 2) that fit 227 KB.  For :func:`launch_plan`'s
    report and the tests' model of the kernel: no launch reads it (the
    kernel takes its shape at compile time, and its tables do not depend on
    it)."""
    c1, c2 = _tier_chunks(inner_passes), _tier_chunks(outer_passes)

    def smem(kb, n1p, d1):
        return (c2 * (2 * n1 // 64) * kb * 128 + d1 * c1 * (n1p + 2 * kb) * 128
                + _PACKED_RING2 * c2 * 64 * 128 + 2 * 32 * (kb + 4) * 4
                + 2 * 8 * (3 + _PACKED_RING2) + 1024)

    for kb in ((64, 32) if n1 <= 128 else (32,)):
        n1p = min(n1, 128)
        while n1p >= 32:
            for d1 in (3, 2):
                if smem(kb, n1p, d1) <= _MAX_SMEM_BYTES:
                    return {"kb": kb, "n1p": n1p, "d1": d1, "smem": smem(kb, n1p, d1)}
            n1p //= 2
    raise ValueError(f"K6t has no shape at n1 {n1}, passes {inner_passes}, {outer_passes}")


def sw128_image(tile: np.ndarray) -> np.ndarray:
    """(..., rows, 64) -> the same values at their places under the 128-byte
    swizzle (featurizer.cu ``sw128``): element (r, c) at column ((c // 8) ^
    (r % 8)) * 8 + c % 8 of row r."""
    r = np.arange(tile.shape[-2])[:, None]
    c = np.arange(64)[None, :]
    out = np.empty_like(tile)
    out[..., r, ((c >> 3) ^ (r & 7)) << 3 | (c & 7)] = tile
    return out


def packed_operands(m: int):
    """K6t's f32 operands of an m-point packed DFT (n1 = 2^(log2 m // 2)),
    from sed_tpu's constants (``_matmul_fft_constants``):
      * A1 (2 n2, 2 n2): row 16t + 8h + i the coefficients of Yr (h = 0) or
        Yi (h = 1) at k2 = 8t + i; column 64 kt + c those of Re z (c < 32)
        or Im z (c >= 32) at a = 32 kt + c mod 32: W2r and -W2i for Yr, W2i
        and W2r for Yi;
      * A2 (2 n1, 2 n1): row 16t + 8h + i the coefficients of Zr (h = 0) or
        Zi (h = 1) at k1 = 8t + i over [Tr | Ti] (column b, n1 + b): W1r
        and -W1i for Zr, W1i and W1r for Zi;
      * the (n2, n1) twiddles as (re, im) pairs."""
    n1, n2, (w2r, w2i), (w1r, w1i), (twr, twi) = stft_ops._matmul_fft_constants(m)
    rows = np.arange(2 * n2)
    k2, h = (rows // 16 * 8 + rows % 8)[:, None], (rows // 8 % 2)[:, None]
    cols = np.arange(2 * n2)
    a, im = (cols // 64 * 32 + cols % 32)[None, :], (cols % 64 >= 32)[None, :]
    a1 = np.where(h == 0, np.where(im, -w2i[k2, a], w2r[k2, a]),
                  np.where(im, w2r[k2, a], w2i[k2, a]))
    rows = np.arange(2 * n1)
    k1, h = (rows // 16 * 8 + rows % 8)[:, None], (rows // 8 % 2)[:, None]
    cols = np.arange(2 * n1)
    b, ti = (cols % n1)[None, :], (cols >= n1)[None, :]
    a2 = np.where(h == 0, np.where(ti, -w1i[b, k1], w1r[b, k1]),
                  np.where(ti, w1r[b, k1], w1i[b, k1]))
    return n1, n2, a1.astype(np.float32), a2.astype(np.float32), np.stack([twr, twi], axis=-1)


@functools.lru_cache(maxsize=16)
def _packed_tables(m: int, inner_chunks: int, outer_chunks: int, device: torch.device):
    """K6t's tables on ``device``: the bf16 chunks of :func:`packed_operands`'
    A1 and A2 in the shared-memory image of each 64-row tile, so that one
    bulk copy brings a tile's chunks (whatever k2 rows a unit the instance
    takes, :func:`packed_plan`):
      * tab1 [mt][kt][chunk][64 rows][64], M tile mt (k2 = 32 mt ..) and K
        tile kt;
      * tab2 [mt][kt][chunk][64 rows][64], M tile mt and K tile kt;
      * the (n2, n1) f32 twiddles as (re, im) pairs."""
    n1, n2, a1, a2, tw = packed_operands(m)

    def image(a, chunks):
        parts = np.stack([c.numpy() for c in split_bf16(torch.from_numpy(a), chunks)])
        r, k = a.shape
        tiles = parts.reshape(chunks, r // 64, 64, k // 64, 64).transpose(1, 3, 0, 2, 4)
        flat = np.ascontiguousarray(sw128_image(tiles)).reshape(-1)
        return torch.from_numpy(flat).to(torch.bfloat16).to(device)

    return image(a1, inner_chunks), image(a2, outer_chunks), torch.from_numpy(tw).to(device)


def _tier_fused(name: str, data: torch.Tensor, kind: int, window: torch.Tensor,
                out: torch.Tensor, rows: int, n_samples: int, n_frames: int, hop: int,
                n_fft: int, passes) -> None:
    """K1t's and K3t's fused route over ``rows`` frames, one-sided power to
    ``out``, a frame group at a time (:func:`fused_plan`): the split pass to
    the group's X planes (``kind`` as K1t's and K3t's), then
    ``tier_fused_kernel`` on the tier GEMMs' tables, counted under
    ``name``."""
    device = data.device
    inner, outer = passes
    plan = fused_plan(n_fft, passes, rows, device)
    tab1, tab2, tw = _gemm_images(n_fft, False, _tier_chunks(inner), _tier_chunks(outer),
                                  plan["tab1_rows"], plan["tab2_rows"], device)
    scratch = torch.empty(plan["x_bytes"], dtype=torch.uint8, device=device)
    x = scratch.data_ptr()
    log2_n = n_fft.bit_length() - 1
    shape = (*_gemm_dims(n_fft), 0, inner, outer)
    row_bytes = 4 * (n_fft // 2 + 1)
    lib, stream = _library(), _stream(device)
    for row0, g in frame_groups(rows, plan["group_frames"]):
        err = lib.sed_tier_split(data.data_ptr(), kind, window.data_ptr(), x, row0, g, n_samples,
                                 n_frames, hop, *shape, device.index, stream)
        _check_launch("tier_split", err)
        LAUNCHES["tier_split"] += 1
        err = lib.sed_tier_dft_power(x, tab1.data_ptr(), tab2.data_ptr(), tw.data_ptr(),
                                     out.data_ptr() + row0 * row_bytes, g, log2_n, inner, outer,
                                     device.index, stream)
        _check_launch(name, err)
        LAUNCHES[name] += 1


def _launch_tier(name: str, kind: int, data: torch.Tensor, window: torch.Tensor,
                 out: torch.Tensor, rows: int, n_samples: int, n_frames: int, hop: int,
                 n_fft: int, passes) -> None:
    """K1t's route (K3t's, K5t's first part; the fused kernel counted under
    ``name``) at n_fft and ``passes``: one-sided power to ``out``."""
    if tier_route("wave_dft_power_bf16", n_fft, passes) == "gemm":
        _tier_gemm(data, kind, window, out, None, rows, n_samples, n_frames, hop, n_fft, passes)
    else:
        _tier_fused(name, data, kind, window, out, rows, n_samples, n_frames, hop, n_fft, passes)


def wave_dft_power_bf16(waves: torch.Tensor, window: torch.Tensor, hop: int, n_fft: int,
                        precision) -> torch.Tensor:
    """(n_sig, samples) f32 -> (n_sig, 1 + samples // hop, n_fft/2 + 1) f32
    power of K1's frames by sed_tpu's matmul DFT at a reduced ``precision``
    (:func:`tier_passes`: 'bf16x1' turbo, 'bf16x3' fast, 'bf16x4',
    'bf16x6', or an (inner, outer) pair).

    CPU tensors take :func:`wave_dft_power_bf16_plain`; CUDA tensors launch
    K1t: the split pass with K1's framing, then ``tier_fused_kernel`` where
    the library's :func:`fused_plan` takes the size and passes (n_fft
    2048..32768), the tier GEMMs elsewhere (128..2^20).  Both go
    through the custom operator ``sed_tpu_torch::wave_dft_power_bf16``, which
    takes the two stages' passes as ints, so an exported program holds it.
    """
    _require_cpu_or_cuda("wave_dft_power_bf16", waves)
    inner, outer = _reduced_passes(precision)
    return torch.ops.sed_tpu_torch.wave_dft_power_bf16(waves, window, hop, n_fft, inner, outer)


@torch.library.custom_op("sed_tpu_torch::wave_dft_power_bf16", mutates_args=(),
                         device_types="cpu")
def _wave_dft_power_bf16_op(waves: torch.Tensor, window: torch.Tensor, hop: int, n_fft: int,
                            inner_passes: int, outer_passes: int) -> torch.Tensor:
    return wave_dft_power_bf16_plain(waves, window, hop, n_fft,
                                     (f"bf16x{inner_passes}", f"bf16x{outer_passes}"))


@_wave_dft_power_bf16_op.register_fake
def _wave_dft_power_bf16_fake(waves, window, hop, n_fft, inner_passes, outer_passes):
    return waves.new_empty((waves.shape[0], 1 + waves.shape[1] // hop, n_fft // 2 + 1))


@_wave_dft_power_bf16_op.register_kernel("cuda")
def _wave_dft_power_bf16_cuda(waves, window, hop, n_fft, inner_passes, outer_passes):
    if waves.device.type != "cuda":
        raise ValueError(f"waves is on {waves.device}, expected a CUDA device")
    passes = (inner_passes, outer_passes)
    if not set(passes) <= set(TIER_PASSES.values()):
        raise ValueError(f"wave_dft_power_bf16: passes {passes} not in {set(TIER_PASSES.values())}")
    n_frames = _check_waves("wave_dft_power_bf16", waves, window, hop, n_fft)
    n_sig, n_samples = waves.shape
    out = torch.empty((n_sig, n_frames, n_fft // 2 + 1), dtype=torch.float32,
                      device=waves.device)
    if n_sig:
        _launch_tier("wave_dft_power_bf16", 0, waves, window, out, n_sig * n_frames,
                     n_samples, n_frames, hop, n_fft, passes)
    return out


def frames_dft_power_bf16(frames: torch.Tensor, window: torch.Tensor, n_fft: int,
                          precision) -> torch.Tensor:
    """(rows, n_fft) f32 or int16 frames -> (rows, n_fft/2 + 1) f32 power of
    K3's function by sed_tpu's matmul DFT at a reduced ``precision`` (as
    :func:`wave_dft_power_bf16`).

    CPU tensors take :func:`frames_dft_power_bf16_plain`; CUDA tensors launch
    K3t (K1t's route with K3's rows in the split pass; the window of int16
    rows scaled by 1/32768 on the card, as :func:`frames_stft_power`).
    """
    passes = _reduced_passes(precision)
    if frames.device.type == "cpu":
        return frames_dft_power_bf16_plain(frames, window, n_fft, precision)
    if frames.device.type != "cuda":
        raise ValueError(f"frames_dft_power_bf16: unsupported device {frames.device}")
    device = frames.device
    if frames.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"frames must be float32 or int16, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    _require_cuda_f32("window", window, device)
    if frames.ndim != 2 or frames.shape[1] != n_fft:
        raise ValueError(f"frames must be (rows, {n_fft}), got {tuple(frames.shape)}")
    rows = frames.shape[0]
    out = torch.empty((rows, n_fft // 2 + 1), dtype=torch.float32, device=device)
    if rows == 0:
        _check_tier_size("frames_dft_power_bf16", n_fft, window, passes)
        return out
    frames = _pair_aligned(frames)
    is_int16 = frames.dtype == torch.int16
    if is_int16:
        window = window / 32768.0
    _launch_tier("frames_dft_power_bf16", 2 if is_int16 else 1, frames, window, out, rows,
                 0, 1, 1, n_fft, passes)
    return out


# ---------------------------------------------------------------------------
# K5t, K6t: 'fuse' and 'pack' at the reduced tiers
# ---------------------------------------------------------------------------

def wave_stft_mel_log_bf16(waves: torch.Tensor, window: torch.Tensor, hop: int, n_fft: int,
                           bands: MelBands, precision, mel_precision=None) -> torch.Tensor:
    """(n_sig, samples) f32 -> (n_sig, 1 + samples // hop, n_mels) f32
    log-mel: K1t at a reduced ``precision`` (:func:`tier_passes`) then K2 at
    ``mel_precision`` (:func:`mel_passes`).

    CPU tensors take :func:`wave_stft_mel_log_bf16_plain`; CUDA tensors
    launch K5t: K1t's route (the split pass, then ``tier_fused_kernel``,
    counted under this wrapper's name, or the tier GEMMs) to a power array,
    then K2; equal to :func:`wave_dft_power_bf16` then :func:`mel_log` bit
    for bit.
    """
    passes = _reduced_passes(precision)
    mode = mel_passes(mel_precision)
    if waves.device.type == "cpu":
        return wave_stft_mel_log_bf16_plain(waves, window, hop, n_fft, bands.dense, precision,
                                            mel_precision)
    if waves.device.type != "cuda":
        raise ValueError(f"wave_stft_mel_log_bf16: unsupported device {waves.device}")
    device = waves.device
    n_frames = _check_waves("wave_stft_mel_log_bf16", waves, window, hop, n_fft)
    _check_bands(bands, device)
    if bands.n_bins != n_fft // 2 + 1:
        raise ValueError(f"bands cover {bands.n_bins} bins, n_fft {n_fft} has "
                         f"{n_fft // 2 + 1}")
    n_sig, n_samples = waves.shape
    rows = n_sig * n_frames
    _check_tier_size("wave_stft_mel_log_bf16", n_fft, window, passes)
    if n_sig == 0:
        return torch.empty((n_sig, n_frames, bands.n_mels), dtype=torch.float32, device=device)
    power = torch.empty((rows, n_fft // 2 + 1), dtype=torch.float32, device=device)
    _launch_tier("wave_stft_mel_log_bf16", 0, waves, window, power, rows, n_samples, n_frames,
                 hop, n_fft, passes)
    return _launch_mel_log(power, bands, mode).reshape(n_sig, n_frames, -1)


def wave_packed_fft_bf16(waves: torch.Tensor, window: torch.Tensor, hop: int, n_fft: int,
                         precision):
    """(n_sig, samples) f32 -> (Zr, Zi), each (n_sig, 1 + samples // hop,
    n_fft/2) f32: K6's function, Z = DFT_m((x_even + i*x_odd) * window) of
    each centred frame in natural bin order, by sed_tpu's matmul DFT of the
    m = n_fft/2 packed points at a reduced ``precision`` (:func:`tier_passes`).

    CPU tensors take :func:`wave_packed_fft_bf16_plain`; CUDA tensors launch
    K6t (``tier_packed_fft_kernel``: wgmma, n_fft 4096..131072; the tier
    GEMMs at 256..2048 and 2^18..2^20).
    """
    passes = _reduced_passes(precision)
    if waves.device.type == "cpu":
        return wave_packed_fft_bf16_plain(waves, window, hop, n_fft, precision)
    if waves.device.type != "cuda":
        raise ValueError(f"wave_packed_fft_bf16: unsupported device {waves.device}")
    device = waves.device
    n_frames = _check_waves("wave_packed_fft_bf16", waves, window, hop, n_fft)
    route = _check_tier_size("wave_packed_fft_bf16", n_fft, window, passes)
    log2_m = n_fft.bit_length() - 2
    n_sig, n_samples = waves.shape
    rows = n_sig * n_frames
    m = n_fft // 2
    chunks = tuple(_tier_chunks(p) for p in passes)
    zr = torch.empty((n_sig, n_frames, m), dtype=torch.float32, device=device)
    zi = torch.empty_like(zr)
    if n_sig == 0:
        return zr, zi
    if route == "gemm":
        _tier_gemm(waves, 0, window, zr, zi, rows, n_samples, n_frames, hop, m, passes)
        return zr, zi
    tab1, tab2, tw = _packed_tables(m, *chunks, device)
    err = _library().sed_tier_packed_fft(
        waves.data_ptr(), window.data_ptr(), tab1.data_ptr(), tab2.data_ptr(), tw.data_ptr(),
        zr.data_ptr(), zi.data_ptr(), rows, n_samples, n_frames, hop, log2_m, *passes,
        device.index, _stream(device))
    _check_launch("wave_packed_fft_bf16", err)
    LAUNCHES["wave_packed_fft_bf16"] += 1
    return zr, zi


# ---------------------------------------------------------------------------
# The drivers, under sed_tpu's names (pallas_featurizer.py without _pallas)
# ---------------------------------------------------------------------------

# sed_tpu's implementation names of the waveform featurizer, and the kernels
# each launches here at the parity tier.  sed_tpu's variants move waveform
# bytes into the TPU's VMEM in different ways (span DMA, phase switches,
# reflect buffers, single or double buffering); the function they compute is
# K1's (K1 then K2 for 'rolledge'), so K1 is their counterpart.  'pack' is K6
# then the unpack and K2; 'fuse' is K5.  :func:`impl_kernels` adds the mel
# modes.
IMPL_KERNELS = {
    "roll": ("wave_stft_power", "mel_log"),
    "roll_nodb": ("wave_stft_power", "mel_log"),
    "slice": ("wave_stft_power", "mel_log"),
    "rollraw": ("wave_stft_power", "mel_log"),
    "rolledge": ("wave_stft_power", "mel_log"),
    "eo": ("wave_stft_power", "mel_log"),
    "pack": ("wave_packed_fft", "mel_log"),
    "fuse": ("wave_stft_mel_log",),
}
# What each name launches at a reduced tier (a ``precision`` other than
# None): K1t in K1's place, K6t in K6's, K5t in K5's; 'slice' ignores the
# precision, as sed_tpu's slice kernel has none.
REDUCED_IMPL_KERNELS = {
    "roll": ("wave_dft_power_bf16", "mel_log"),
    "roll_nodb": ("wave_dft_power_bf16", "mel_log"),
    "slice": ("wave_stft_power", "mel_log"),
    "rollraw": ("wave_dft_power_bf16", "mel_log"),
    "rolledge": ("wave_dft_power_bf16", "mel_log"),
    "eo": ("wave_dft_power_bf16", "mel_log"),
    "pack": ("wave_packed_fft_bf16", "mel_log"),
    "fuse": ("wave_stft_mel_log_bf16",),
}
# At a bf16 ``mel_precision`` K2 runs its product mode and K5 is K5b, on the
# names whose mel reads it ('eo', 'rolledge' and 'pack' run the parity mel,
# as sed_tpu's do); K5t takes the mode as an argument.
_MEL_MODE_KERNELS = {"mel_log": "mel_log_bf16", "wave_stft_mel_log": "wave_stft_mel_log_mel_bf16"}
_PARITY_MEL_IMPLS = ("eo", "rolledge", "pack")


def impl_kernels(impl: str, precision=None, mel_precision=None,
                 n_fft: Optional[int] = None) -> tuple:
    """The kernels (:data:`LAUNCHES` names) that ``logmel_waveform(impl=impl,
    precision=precision, mel_precision=mel_precision)`` launches on a CUDA
    tensor, once each: the wrappers' one-launch kernels, and with ``n_fft``
    the kernels of each wrapper's route at that size and precision in its
    place (:func:`launch_plan`)."""
    passes = tier_passes(precision)
    names = (IMPL_KERNELS if passes is None else REDUCED_IMPL_KERNELS)[impl]
    mode = bool(mel_passes(mel_precision)) and impl not in _PARITY_MEL_IMPLS
    if mode:
        names = tuple(_MEL_MODE_KERNELS.get(n, n) for n in names)
    if n_fft is None:
        return names
    plan, out = launch_plan(n_fft, passes=passes), []
    parity_name = {v: k for k, v in _MEL_MODE_KERNELS.items()}
    for name in names:
        p = plan[parity_name.get(name, name)]
        if p["route"] == "one":
            out.append(name)
            continue
        if p["kernels"] is None:
            raise ValueError(f"{name}'s route at n_fft {n_fft} is the kernel library's "
                             f"choice (fused_plan), which needs a card")
        out.extend(_MEL_MODE_KERNELS["mel_log"] if mode and k == "mel_log" else k
                   for k in p["kernels"])
    return tuple(out)

# sed_tpu's frames per TPU tile (FFT_TILE_R): its raw-read geometry, whose
# preconditions the port keeps, is counted in these tiles.
_TPU_TILE_FRAMES = 8
_TPU_TILE_K = 2048  # sed_tpu's TILE_K: 'fuse' needs nfft to be a multiple


def _check_rollraw(cfg: SpectrogramConfig, n_samples: int, impl: str) -> None:
    """sed_tpu's preconditions of 'rollraw' and 'rolledge'
    (``_rollraw_layout``): n_samples % 128 == 0, nfft >= 32768, and a signal
    long enough for at least one tile that never enters the reflect pad.
    K1 needs none of them; they are kept for parity only (ROADMAP.md, S2)."""
    n_fft, hop = cfg.nfft, cfg.hop_size
    if n_samples % 128 != 0 or n_fft < 32768:
        raise ValueError(f"{impl} needs n_samples % 128 == 0 and nfft >= 32768, "
                         f"got n_samples {n_samples}, nfft {n_fft}")
    tile_stride = _TPU_TILE_FRAMES * hop
    span_len = 1024 + (_TPU_TILE_FRAMES - 1) * hop + n_fft
    span_len += (-span_len) % 1024
    first_interior = -(-(n_fft // 2) // tile_stride)
    last_interior = (n_samples - span_len) // tile_stride
    if last_interior < first_interior:
        raise ValueError(f"{impl} needs a signal with interior tiles: {n_samples} "
                         f"samples are too short")


def _check_even_odd(cfg: SpectrogramConfig, impl: str) -> None:
    if cfg.nfft % 2 or cfg.hop_size % 2:
        raise ValueError(f"{impl}: the even/odd paths need even nfft and hop, got "
                         f"nfft {cfg.nfft}, hop {cfg.hop_size}")


def _wave_power(waveforms: torch.Tensor, cfg: SpectrogramConfig, precision) -> torch.Tensor:
    """K1 at the parity tier (``precision`` None), K1t at a reduced one."""
    window = stft_window(cfg, waveforms.device)
    if tier_passes(precision) is None:
        return wave_stft_power(waveforms, window, cfg.hop_size, cfg.nfft)
    return wave_dft_power_bf16(waveforms, window, cfg.hop_size, cfg.nfft, precision)


def stft_power_from_waveform(waveforms: torch.Tensor,
                             cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                             impl: str = "roll", precision=None) -> torch.Tensor:
    """(n_signals, samples) f32 -> (n_signals, n_frames, n_fft/2 + 1) one-
    sided power through K1 (K1t at a reduced ``precision``,
    :func:`tier_passes`), for each of sed_tpu's impl names 'roll',
    'roll_nodb', 'slice' and 'rollraw'.  'slice' ignores ``precision``, as
    sed_tpu's slice kernel has none.

    ``sed_tpu`` returns all n_fft bins in its (k2, k1) tile layout; the
    port returns the one-sided spectrum in natural order (K1's divergence).
    'roll_aligned_debug' gives wrong values by design in ``sed_tpu`` (a
    profiling aid) and raises ``NotImplementedError``.
    """
    tier_passes(precision)
    if impl == "rollraw":
        return stft_power_from_waveform_raw(waveforms, cfg, precision)
    if impl == "roll_aligned_debug":
        raise NotImplementedError("impl 'roll_aligned_debug' is a profiling aid of "
                                  "sed_tpu that gives wrong values; it is not ported")
    if impl not in ("roll", "roll_nodb", "slice"):
        raise ValueError(f"unknown impl {impl!r} for stft_power_from_waveform")
    return _wave_power(waveforms, cfg, None if impl == "slice" else precision)


def stft_power_from_waveform_raw(waveforms: torch.Tensor,
                                 cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                                 precision=None) -> torch.Tensor:
    """impl='rollraw': K1 (K1t at a reduced ``precision``), under sed_tpu's
    preconditions for it (raises ``ValueError`` where sed_tpu asserts).  K1
    reads the unpadded waveform and reflects on the index for every frame,
    which is rollraw's design."""
    tier_passes(precision)
    _check_rollraw(cfg, waveforms.shape[-1], "rollraw")
    return _wave_power(waveforms, cfg, precision)


def stft_eo_power_from_waveform(waveforms: torch.Tensor,
                                cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                                precision=None) -> torch.Tensor:
    """impl='eo': (n_signals, samples) -> (n_signals, n_frames, m + 1) one-
    sided power (m = n_fft/2, column m the Nyquist bin) through K1, whose
    unpack is the even/odd identity X[k] = E[k] + W^k O[k]; K1t at a reduced
    ``precision`` (sed_tpu's even/odd packing rounds elsewhere: the same
    tier's class, not its bits).

    ``sed_tpu`` writes columns 0..m-1 in the half transform's (k2, k1) tile
    layout and pads to m + 128 columns; the port writes natural order, no
    padding.
    """
    tier_passes(precision)
    _check_even_odd(cfg, "eo")
    return _wave_power(waveforms, cfg, precision)


def stft_packed_from_waveform(waveforms: torch.Tensor,
                              cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                              precision=None):
    """impl='pack': (n_signals, samples) -> (Zr, Zi), each (n_signals,
    n_frames, m), Z = FFT_m((x_even + i*x_odd) * window) of each centred
    frame in natural bin order, through K6 (K6t at a reduced ``precision``,
    :func:`tier_passes`).  Feed to :func:`packed_power_onesided`, then
    :func:`power_to_logmel_cuda`."""
    passes = tier_passes(precision)
    _check_even_odd(cfg, "pack")
    window = stft_window(cfg, waveforms.device)
    if passes is None:
        return wave_packed_fft(waveforms, window, cfg.hop_size, cfg.nfft)
    return wave_packed_fft_bf16(waveforms, window, cfg.hop_size, cfg.nfft, precision)


def packed_power_onesided(zr: torch.Tensor, zi: torch.Tensor,
                          n_fft: int) -> torch.Tensor:
    """(..., m) packed FFT in natural order -> (..., m + 1) one-sided power:
    |X|^2 of the hermitian unpack (PyTorch ops here, as sed_tpu's
    ``packed_power_onesided`` is XLA there); column m is the Nyquist bin
    (Re Z[0] - Im Z[0])^2."""
    xr, xi = stft_ops.hermitian_unpack(zr, zi, n_fft)
    return xr * xr + xi * xi


def power_to_logmel_cuda(power: torch.Tensor,
                         cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                         mel_precision=None) -> torch.Tensor:
    """K4 (sed_tpu's ``power_to_logmel_pallas``): (..., freq_bins) one-sided
    power -> (..., mel_bins) f32 log-mel through K2, which takes any number
    of bins with no filterbank size limit (sed_tpu streams its filterbank
    over K past 24 MB); ``mel_precision`` as :func:`mel_log`."""
    lead = power.shape[:-1]
    x = power.reshape(-1, power.shape[-1]).to(torch.float32).contiguous()
    mel = mel_log(x, mel_bands(cfg, power.device), mel_precision)
    return mel.reshape(*lead, cfg.mel_bins)


def logmel_waveform_fused(waveforms: torch.Tensor,
                          cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                          precision=None, mel_precision="bf16x4") -> torch.Tensor:
    """impl='fuse': (n_signals, samples) -> (n_signals, n_frames, mel_bins):
    K5 at the parity tier in one launch (K5b at a ``mel_precision`` with
    bf16 passes), K5t at a reduced ``precision``; each equal to its power
    kernel (K1, K1t) then K2 at ``mel_precision`` bit for bit, as sed_tpu
    pins fuse == roll."""
    passes = tier_passes(precision)
    mel_passes(mel_precision)
    if cfg.nfft % _TPU_TILE_K:
        raise ValueError(f"fuse needs nfft % {_TPU_TILE_K} == 0, got {cfg.nfft}")
    device = waveforms.device
    window, bands = stft_window(cfg, device), mel_bands(cfg, device)
    if passes is None:
        return wave_stft_mel_log(waveforms, window, cfg.hop_size, cfg.nfft, bands,
                                 mel_precision)
    return wave_stft_mel_log_bf16(waveforms, window, cfg.hop_size, cfg.nfft, bands, precision,
                                  mel_precision)


def logmel_waveform_rolledge(waveforms: torch.Tensor,
                             cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                             precision=None) -> torch.Tensor:
    """impl='rolledge': K1 (K1t at a reduced ``precision``) then K2, under
    sed_tpu's rollraw preconditions.  sed_tpu splits its grid into raw-read
    interior tiles and repacked edge strips; K1 reflects on the index, so
    every frame is an interior one.  Its mel is the parity mel, as sed_tpu's."""
    tier_passes(precision)
    _check_rollraw(cfg, waveforms.shape[-1], "rolledge")
    return power_to_logmel_cuda(_wave_power(waveforms, cfg, precision), cfg)


def logmel_waveform(waveforms: torch.Tensor,
                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                    impl: str = "roll", precision=None,
                    mel_precision=None) -> torch.Tensor:
    """(n_signals, samples) f32 -> (n_signals, n_frames, mel_bins) f32
    log-mel (counterpart of ``logmel_waveform_pallas``).

    ``impl`` takes every name of ``sed_tpu`` (:func:`impl_kernels` lists the
    kernels each launches on a CUDA tensor at each ``precision`` and
    ``mel_precision``; a CPU tensor takes their plain versions).
    ``precision``: sed_tpu's values (:func:`tier_passes`); ``mel_precision``
    (:func:`mel_passes`) reaches K2 (K5's epilogue for 'fuse') on the paths
    where sed_tpu's reaches its mel kernel ('roll', 'roll_nodb', 'slice',
    'rollraw', 'fuse'; 'eo', 'rolledge' and 'pack' run the parity mel).
    """
    tier_passes(precision)
    mel_passes(mel_precision)
    if impl == "fuse":
        return logmel_waveform_fused(waveforms, cfg, precision, mel_precision or "bf16x4")
    if impl == "rolledge":
        return logmel_waveform_rolledge(waveforms, cfg, precision)
    if impl == "eo":
        return power_to_logmel_cuda(stft_eo_power_from_waveform(waveforms, cfg, precision), cfg)
    if impl == "pack":
        zr, zi = stft_packed_from_waveform(waveforms, cfg, precision)
        return power_to_logmel_cuda(packed_power_onesided(zr, zi, cfg.nfft), cfg)
    power = stft_power_from_waveform(waveforms, cfg, impl, precision)
    return power_to_logmel_cuda(power, cfg, mel_precision)

"""ctypes bindings for the native C++ audio reader (counterpart of
``sed_tpu.io.native``).

``csrc/sed_native.cpp`` (the port's own copy of the reader, same C ABI) is
compiled at first use by ``$CXX`` (default ``g++``) with the flags
``-O3 -march=native -fPIC -shared -Wall -pthread`` into ``_build/`` next to
this file (git-ignored), and loaded with ctypes.  The library's name carries
a hash of the source, the compiler, the flags and what ``-march=native``
resolves to on this host (:func:`library_digest`), so a library built on
another CPU is never loaded.  A failed build raises with the compiler's
output: there is no fallback, and :func:`native_available` is True or
raises.  The scipy decoder and the Python batch path of
``sed_tpu_torch.io.audio`` are the plain versions the tests hold this
reader against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from sed_tpu_torch.io.audio import KAISER_BEST_BETA, KAISER_BEST_ZERO_CROSSINGS

SOURCE = Path(__file__).resolve().parent / "csrc" / "sed_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-pthread")

_lock = threading.Lock()


class _SedWav(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("frames", ctypes.c_int64),
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
    ]


class _SedAudioOut(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("frames", ctypes.c_int64),
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("rc", ctypes.c_int32),
    ]


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str        # the compiler's output


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _run(cmd) -> str:
    """Run the compiler; its output, or a RuntimeError carrying it."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native reader build failed: {' '.join(cmd)}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"native reader build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    return log


@functools.cache
def library_digest() -> str:
    """The hash that names the library: the source, the compiler, the flags,
    and the target options ``-march=native`` resolves to on this host."""
    cxx = _cxx()
    target = _run([cxx, "-march=native", "-Q", "--help=target"])
    key = b"\0".join([SOURCE.read_bytes(), cxx.encode(), " ".join(CXXFLAGS).encode(),
                      target.encode()])
    return hashlib.sha1(key).hexdigest()[:12]


def library_path() -> Path:
    return BUILD_DIR / f"libsed_native_{library_digest()}.so"


def build(force: bool = False) -> BuildInfo:
    """Compile ``csrc/sed_native.cpp`` into ``_build/``, unless the library of
    this digest is there already (or ``force``).  The build writes a
    temporary file and renames it, so concurrent processes never load a
    half-written library.  Raises RuntimeError with the compiler's output
    when the build fails."""
    path = library_path()
    if path.exists() and not force:
        return BuildInfo(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run([_cxx(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)
    return BuildInfo(path, time.perf_counter() - t0, log)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build().path))
        lib.sed_read_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(_SedWav)]
        lib.sed_read_wav.restype = ctypes.c_int
        lib.sed_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.sed_free.restype = None
        lib.sed_resample_len.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.sed_resample_len.restype = ctypes.c_int64
        lib.sed_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.sed_resample.restype = ctypes.c_int
        lib.sed_load_multichannel_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(_SedAudioOut),
        ]
        lib.sed_load_multichannel_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def native_available() -> bool:
    """True once the library is built and loaded (building it at first
    call); a failed build raises RuntimeError instead of returning False."""
    _library()
    return True


def read_wav_native(path) -> tuple:
    """Decode a WAV file with the C++ parser -> (float64 (frames, channels),
    rate).  The samples pass through float32, as ``sed_tpu``'s native path's
    do (32-bit PCM and float64 WAVs are rounded to float32)."""
    lib = _library()
    wav = _SedWav()
    rc = lib.sed_read_wav(os.fsencode(path), ctypes.byref(wav))
    if rc != 0:
        raise ValueError(f"sed_read_wav({path}) failed with code {rc}")
    try:
        # The cast to float64 is the one copy out of the library's buffer.
        total = wav.frames * wav.channels
        data = np.ctypeslib.as_array(wav.data, shape=(total,)).astype(np.float64)
    finally:
        lib.sed_free(wav.data)
    return data.reshape(wav.frames, wav.channels), int(wav.sample_rate)


def load_multichannel_batch_native(
    paths, audio_channels: int, target_fs: int | None, threads: int = 4,
    beta: float = KAISER_BEST_BETA,
    half_zero_crossings: int = KAISER_BEST_ZERO_CROSSINGS,
) -> list:
    """Many files through the acquisition pipeline on ``threads`` C++
    threads, outside the GIL: per file, WAV decode -> channel policy (repeat
    the mean channel / mono mean / truncate, as
    ``io.audio.read_multichannel_audio``) -> per-channel polyphase resample
    to ``target_fs``.

    Returns a list of float32 (frames, channels) arrays in input order.
    Raises ValueError naming the first file that failed (the rest of the
    batch still loads and is freed).
    """
    lib = _library()
    paths = list(paths)
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (_SedAudioOut * n)()
    lib.sed_load_multichannel_batch(c_paths, n, int(audio_channels), int(target_fs or 0),
                                    float(beta), int(half_zero_crossings), int(threads), outs)
    arrays, first_err = [], None
    for i in range(n):
        o = outs[i]
        if o.rc != 0 or not o.data:
            if first_err is None:
                first_err = (paths[i], o.rc)
            arrays.append(None)
            continue
        try:
            total = o.frames * o.channels
            arr = np.ctypeslib.as_array(o.data, shape=(total,)).copy()
        finally:
            lib.sed_free(o.data)
        arrays.append(arr.reshape(o.frames, o.channels))
    if first_err is not None:
        raise ValueError(f"native batch load failed for {first_err[0]!r} "
                         f"(code {first_err[1]})")
    return arrays


def resample_native(x: np.ndarray, up: int, down: int, beta: float = KAISER_BEST_BETA,
                    half_zero_crossings: int = KAISER_BEST_ZERO_CROSSINGS) -> np.ndarray:
    """Polyphase windowed-sinc resample of a 1-D array (float32 in, float64
    out)."""
    lib = _library()
    xin = np.ascontiguousarray(x, dtype=np.float32)
    n = len(xin)
    out = np.empty(lib.sed_resample_len(n, up, down), dtype=np.float32)
    rc = lib.sed_resample(xin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, up, down,
                          beta, half_zero_crossings,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"sed_resample failed with code {rc}")
    return out.astype(np.float64)

"""The port's native WAV reader (``sed_tpu_torch/io/native.py``) and the
acquisition paths on it, against sed_tpu's (CPU).

The port compiles its own copy of the reader (``io/csrc/sed_native.cpp``)
with ``native/Makefile``'s compiler and flags; ``sed_tpu`` decodes through
``native/libsed_native.so`` whenever that library is built.  Held:

  * ``read_wav`` equals ``sed_tpu.io.audio.read_wav`` bit for bit on 16-,
    24- and 32-bit PCM and float32 WAVs, and the scipy plain version within
    float32 rounding (the reader's samples pass through float32);
  * ``load_multichannel_batch_native`` and ``resample_native`` equal
    sed_tpu's bit for bit at 48 kHz and at 44.1 kHz (resampled), when
    sed_tpu's library is this host's build of the same source (its bytes
    equal a fresh build of ``native/sed_native.cpp`` made here into a
    temporary directory; neither package's file is rebuilt).  A
    ``native/libsed_native.so`` built elsewhere (another CPU's
    ``-march=native``, another compiler) may contract the resampler's
    multiply-adds differently: the resampled case then falls back to one
    float32 ulp of the output (2**-23 relative, plus 2**-30 absolute for
    samples near 0) and says so.  Where sed_tpu's library did not load in
    this process (its build at first use failed), sed_tpu decodes with
    scipy: the port is then held to sed_tpu's Python path within float32
    rounding, and within the resampler bound below where it resamples, and
    the test says so;
  * the native and scipy batch paths agree to float32 rounding at 48 kHz,
    and at 44.1 kHz within ``benchmarks/RESAMPLER_PARITY.json``'s bound
    (each path within ``worst_max_err_dbfs`` of a float64 oracle, so within
    twice that of each other);
  * ``preprocess_data(workers=4)``'s pickles equal ``workers=0``'s at 48
    kHz; a WAV that fails to decode is attributed to its own file;
  * a broken compiler (``CXX=false``) raises instead of falling back.
"""

import json
import os
import pickle
import subprocess
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu.configs import AudioConfig as JaxAudioConfig
from sed_tpu.io import audio as jax_audio
from sed_tpu.io import native as jax_native
from sed_tpu_torch.configs import AudioConfig, SpectrogramConfig
from sed_tpu_torch.data.preprocess import preprocess_data
from sed_tpu_torch.io import audio, native

REPO = Path(__file__).resolve().parents[1]
F32_REL, F32_ULP, F32_ABS = 2.0**-24, 2.0**-23, 2.0**-30
PARITY = json.loads((REPO / "benchmarks" / "RESAMPLER_PARITY.json").read_text())
RESAMPLER_TOL = 2 * 10 ** (PARITY["worst_max_err_dbfs"] / 20)   # two paths, full scale 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_pcm24(path, x, sr):
    """A 24-bit PCM WAV of float ``x`` (samples, channels) in [-1, 1)."""
    q = np.clip(np.round(x * 2**23), -2**23, 2**23 - 1).astype(np.int32)
    raw = q.reshape(-1).astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(3)
        w.setframerate(sr)
        w.writeframes(raw)
    return str(path)


def write_kind(path, kind, x, sr):
    """``x`` (samples, channels) in [-0.9, 0.9] as a WAV of ``kind``."""
    if kind == "pcm16":
        wavfile.write(path, sr, np.round(x * 32767).astype(np.int16))
    elif kind == "pcm24":
        write_pcm24(path, x, sr)
    elif kind == "pcm32":
        wavfile.write(path, sr, np.round(x * (2**31 - 1)).astype(np.int32))
    else:
        wavfile.write(path, sr, x.astype(np.float32))
    return str(path)


def sed_tpu_library(tmp_path) -> str:
    """'fresh' when sed_tpu decodes through a library whose bytes equal a
    build of ``native/sed_native.cpp`` made here with ``native/Makefile``'s
    compiler and flags (into ``tmp_path``), 'stale' when it loaded another
    build, 'absent' when it did not load one (it then decodes with scipy)."""
    if not jax_native.native_available():
        print("sed_tpu's native library did not load: held to its scipy path")
        return "absent"
    fresh = tmp_path / "fresh.so"
    proc = subprocess.run([os.environ.get("CXX") or "g++", *native.CXXFLAGS, "-o", str(fresh),
                           "sed_native.cpp"], cwd=REPO / "native", capture_output=True)
    if proc.returncode == 0 and fresh.read_bytes() == Path(jax_native._SO_PATH).read_bytes():
        return "fresh"
    print("native/libsed_native.so is not this host's build of its source: the resampled "
          "cases are held to one float32 ulp instead of bit equality")
    return "stale"


def assert_equal_or_ulp(got, want, exact, what):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_ULP, atol=F32_ABS, err_msg=what)


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "pcm32", "float32"])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_equals_sed_tpu(kind, channels, tmp_path):
    x = 0.9 * np.tanh(np.random.default_rng(channels).standard_normal((6001, channels)))
    path = write_kind(tmp_path / f"{kind}.wav", kind, x, 44100)
    got, sr = audio.read_wav(path)
    want, jsr = jax_audio.read_wav(path)
    assert sr == jsr == 44100 and got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (6001, channels)
    if kind == "pcm32" and not jax_native.native_available():
        print("sed_tpu's native library did not load: its scipy decode keeps 32-bit "
              "PCM in float64, held within float32 rounding")
        np.testing.assert_allclose(got, want, rtol=F32_REL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    plain, _ = audio.read_wav_plain(path)
    # The plain version keeps float64: equal where float32 holds the sample
    # exactly (16 and 24 bits), else within its rounding.
    np.testing.assert_allclose(got, plain, rtol=F32_REL, atol=0)
    if kind in ("pcm16", "pcm24", "float32"):
        np.testing.assert_array_equal(got, plain)


def corpus(tmp_path, rates, seed=0):
    """int16 WAVs of (rate, channels, seconds) with mean-free noise."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, (sr, ch, secs) in enumerate(rates):
        x = 0.25 * rng.standard_normal((int(secs * sr), ch))
        paths.append(write_kind(tmp_path / f"c{i}.wav", "pcm16", np.clip(x, -0.9, 0.9), sr))
    return paths


@pytest.mark.parametrize("rate", [48000, 44100])
@pytest.mark.parametrize("channels", [1, 2])
def test_batch_loader_equals_sed_tpu(rate, channels, tmp_path):
    """``load_multichannel_batch_native`` on three threads, every channel
    policy (mono mean, repeated mean, truncation), against sed_tpu's."""
    paths = corpus(tmp_path, [(rate, 1, 0.7), (rate, 2, 0.5), (rate, 3, 0.6), (rate, 2, 0.3)])
    got = native.load_multichannel_batch_native(paths, channels, 48000, threads=3)
    state = sed_tpu_library(tmp_path)
    if state == "absent":
        cfg = JaxAudioConfig(audio_channels=channels)
        want = [jax_audio.read_multichannel_audio(p, 48000, cfg).astype(np.float32)
                for p in paths]
    else:
        want = jax_native.load_multichannel_batch_native(paths, channels, 48000, threads=3)
    for g, w, p in zip(got, want, paths):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, p
        assert g.shape[1] == channels
        if state == "absent" and rate != 48000:
            np.testing.assert_allclose(g, w, rtol=F32_ULP, atol=RESAMPLER_TOL, err_msg=p)
        else:
            assert_equal_or_ulp(g, w, rate == 48000 and state != "absent" or state == "fresh",
                                p)


def test_resample_native_equals_sed_tpu(tmp_path):
    x = np.random.default_rng(3).standard_normal(5000) * 0.2
    state = sed_tpu_library(tmp_path)
    for up, down in ((160, 147), (3, 1), (1, 3)):
        got = native.resample_native(x, up, down)
        assert got.dtype == np.float64 and len(got) == -(-len(x) * up // down)
        if state == "absent":   # sed_tpu's scipy resampler, the same Kaiser design
            want = jax_audio.resample(x.astype(np.float32).astype(np.float64), down * 48000,
                                      up * 48000)
            np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLER_TOL)
        else:
            assert_equal_or_ulp(got, jax_native.resample_native(x, up, down),
                                state == "fresh", (up, down))


@pytest.mark.parametrize("rate", [48000, 44100])
def test_native_and_plain_batch_paths_agree(rate, tmp_path):
    """``read_multichannel_audio_batch(workers=3)`` (the reader's threads)
    against the plain path (scipy decode and resampler, Python threads): at
    48 kHz within float32 rounding, at 44.1 kHz within the resampler
    bound; ``workers=0`` (native decode, scipy resampler) likewise."""
    paths = corpus(tmp_path, [(rate, 2, 0.8), (rate, 1, 0.5), (rate, 3, 0.6)], seed=5)
    cfg = AudioConfig(audio_channels=1)
    plain = audio.read_multichannel_audio_batch_plain(paths, 48000, cfg, workers=3)
    tol = F32_ABS if rate == 48000 else RESAMPLER_TOL
    for workers in (3, 0):
        got = audio.read_multichannel_audio_batch(paths, 48000, cfg, workers=workers)
        worst = 0.0
        for g, p in zip(got, plain):
            assert g.dtype == p.dtype == np.float32 and g.shape == p.shape
            np.testing.assert_allclose(g, p, rtol=F32_REL, atol=tol)
            worst = max(worst, float(np.abs(g - p).max()))
        print(f"{rate} Hz, workers={workers}: native against plain {worst:.3e} (tol {tol:.3e})")


def test_batch_api_follows_sed_tpu_per_worker_count(tmp_path):
    """``read_multichannel_audio_batch`` at each worker count equals
    sed_tpu's at the same count (both decode natively; with workers > 1
    both run the reader's batch pipeline)."""
    paths = corpus(tmp_path, [(48000, 2, 0.4), (44100, 1, 0.5), (16000, 1, 0.3)], seed=7)
    state = sed_tpu_library(tmp_path)
    for workers in (0, 1, 4):
        got = audio.read_multichannel_audio_batch(paths, 48000, AudioConfig(audio_channels=2),
                                                  workers=workers)
        want = jax_audio.read_multichannel_audio_batch(
            paths, 48000, JaxAudioConfig(audio_channels=2), workers=workers)
        for g, w, p in zip(got, want, paths):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            if state == "absent" and workers > 1:   # sed_tpu's Python threads, scipy's resampler
                np.testing.assert_allclose(g, w, rtol=F32_ULP, atol=RESAMPLER_TOL)
            else:
                assert_equal_or_ulp(g, w, state == "fresh" or workers <= 1, (workers, p))


def labelled(paths):
    return [(p, np.array([0.2]), np.array([0.5]), Path(p).stem) for p in paths]


def test_preprocess_workers_pickles_equal_sequential(tmp_path):
    """``preprocess_data(workers=4)`` on 48 kHz files (more than one group of
    the producer): every pickle and the mean/std equal ``workers=0``'s."""
    cfg = SpectrogramConfig()
    items = labelled(corpus(tmp_path, [(48000, 1, 1.2)] * 6 + [(48000, 2, 0.9)], seed=9))
    for w in (0, 4):
        preprocess_data(items, str(tmp_path / f"f{w}"), str(tmp_path / f"m{w}.pkl"),
                        cfg=cfg, workers=w, device="cpu", plot_sample=False)
    names = sorted(os.listdir(tmp_path / "f0"))
    assert names == sorted(os.listdir(tmp_path / "f4")) and len(names) == len(items)
    for a, b in [(tmp_path / "f0" / n, tmp_path / "f4" / n) for n in names] + [
            (tmp_path / "m0.pkl", tmp_path / "m4.pkl")]:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            da, db = pickle.load(fa), pickle.load(fb)
        assert da.keys() == db.keys()
        for key in da:
            np.testing.assert_array_equal(da[key], db[key], err_msg=f"{a.name} {key}")


def test_undecodable_wav_is_attributed_to_its_own_file(tmp_path):
    """A file that is no WAV, in the middle of the list: the batch loader
    names it; ``preprocess_data(workers=2)`` re-reads its group file by
    file, writes the pickles of the files before it, and raises the
    reader's error for that file at its turn, as ``workers=0`` does."""
    paths = corpus(tmp_path, [(48000, 1, 0.5)] * 5, seed=11)
    bad = tmp_path / "c2.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00JUNKnot a wave file at all" * 4)
    with pytest.raises(ValueError, match="c2.wav"):
        native.load_multichannel_batch_native(paths, 1, 48000, threads=2)
    for w in (0, 2):
        out = tmp_path / f"f{w}"
        with pytest.raises(ValueError, match=r"c2\.wav"):
            preprocess_data(labelled(paths), str(out), str(tmp_path / f"m{w}.pkl"),
                            cfg=SpectrogramConfig(), workers=w, device="cpu",
                            plot_sample=False)
        assert sorted(os.listdir(out)) == [f"c{i}_logMel_features_and_labels.pkl"
                                           for i in (0, 1)], w


def test_broken_compiler_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """With ``CXX=false`` and no library built for it, decoding raises the
    compiler's failure; nothing falls back to scipy."""
    path = corpus(tmp_path, [(48000, 1, 0.2)])[0]
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library_digest.cache_clear()
    try:
        for call in (lambda: audio.read_wav(path), native.native_available,
                     lambda: audio.read_multichannel_audio_batch([path, path], 48000,
                                                                 workers=2)):
            with pytest.raises(RuntimeError, match="native reader build failed"):
                call()
        assert not (tmp_path / "build").exists()
    finally:
        native.library_digest.cache_clear()


def test_library_is_built_from_the_ports_own_source():
    """The source lies in the package; the library in its git-ignored
    ``_build/``, named by a digest of source, compiler, flags and target."""
    package = REPO / "sed_tpu_torch"
    assert native.SOURCE.is_relative_to(package) and native.SOURCE.exists()
    info = native.build()
    assert info.path.parent == package / "io" / "_build"
    assert native.library_digest() in info.path.name
    assert native.CXXFLAGS == ("-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-pthread")
    assert "sed_tpu_torch/io/_build/" in (REPO / ".gitignore").read_text().splitlines()

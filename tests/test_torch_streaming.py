"""sed_tpu_torch streaming against sed_tpu's, on the CPU.

  * the schedule functions (``tick_schedule``, ``emission_upto``,
    ``window_start``) give identical results over fuzzed counters;
  * K3's plain version and ``logmel_frames`` against ``stft_power_pallas``
    and ``logmel_frames_pallas`` in interpret mode (total energy rtol 1e-5,
    log-mel <= 1e-4 dB) for float32 and int16 frames;
  * the three detectors against ``sed_tpu``'s on weights carried across with
    ``models/convert.py``: per-push scores <= 1e-5 and identical emission
    counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu import device_streaming as jax_device_streaming
from sed_tpu import streaming as jax_streaming
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.ops.pallas_featurizer import logmel_frames_pallas, stft_power_pallas
from sed_tpu_torch import device_streaming, streaming
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.featurizer import logmel_frames

SMALL = dict(working_sample_rate=8000, time_margin=0.33)
CFG, JCFG = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
KW = dict(halo=64, total_stride=8, bucket=64)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(flax model, params, batch_stats, port model) with the same weights."""
    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL)
    variables = flax_model.init(jax.random.key(0),
                                jnp.zeros((1, CFG.train_crop_size, CFG.mel_bins, 1)),
                                train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    return flax_model, params, stats, port


# -- schedule ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_functions_identical_over_fuzzed_counters(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        sr = int(rng.integers(4000, 48001))
        tm = float(rng.uniform(0.05, 0.4))
        cfg, jcfg = SpectrogramConfig(sr, tm), JaxSpectrogramConfig(sr, tm)
        hop = cfg.hop_size
        stride = int(rng.choice([1, 2, 4, 8]))
        halo = stride * int(rng.integers(1, 12))
        bucket = int(rng.choice([64, 128]))
        chunk = int(rng.integers(hop // 3 + 1, 4 * hop))
        geometry = device_streaming.ring_geometry(cfg, chunk, halo, stride, bucket)
        frames_max, emit_max, ring_m, ring_l = geometry

        for n in rng.integers(0, 500, 20):
            n = int(n)
            for final in (False, True):
                assert (streaming.emission_upto(n, stride, halo, final)
                        == jax_streaming.emission_upto(n, stride, halo, final))
            assert (streaming.window_start(n, stride, halo)
                    == jax_streaming.window_start(n, stride, halo))

        t0 = chunk * (-(-(cfg.nfft + hop) // chunk))
        n_frames = max(0, (t0 - cfg.nfft // 2) // hop + 1)
        emitted = streaming.emission_upto(n_frames, stride, halo, final=False)
        c = {"t_total": t0, "n_frames": n_frames, "emitted": emitted,
             "mel_start": streaming.window_start(emitted, stride, halo)}
        jc = dict(c)
        for _ in range(40):
            got = streaming.tick_schedule(c, chunk, frames_max, emit_max, ring_m,
                                          ring_l, cfg, stride, halo)
            want = jax_streaming.tick_schedule(jc, chunk, frames_max, emit_max,
                                               ring_m, ring_l, jcfg, stride, halo)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[0].dtype == want[0].dtype
            assert got[1:] == want[1:]
            c, jc = got[-1], want[-1]


@pytest.mark.parametrize("name", ["DEFAULT_CHANNEL_AND_POOL", "TRAIN_CHANNEL_AND_POOL"])
def test_receptive_field_matches_sed_tpu(name):
    from sed_tpu.models import cnn as jax_cnn
    from sed_tpu.parallel.time_shard import receptive_field as jax_receptive_field
    from sed_tpu_torch.models import cnn
    from sed_tpu_torch.parallel.time_shard import receptive_field

    config = getattr(cnn, name)
    assert receptive_field(config) == jax_receptive_field(getattr(jax_cnn, name))
    assert receptive_field(((8, 2), (8, 1))) == jax_receptive_field([(8, 2), (8, 1)])


def test_mulaw_decode_np_matches_sed_tpu():
    from sed_tpu.ops.mulaw import mulaw_decode_np as jax_mulaw_decode_np
    from sed_tpu_torch.ops.mulaw import mulaw_decode, mulaw_decode_np

    codes = np.arange(256, dtype=np.uint8)
    got = mulaw_decode_np(codes)
    np.testing.assert_array_equal(got, jax_mulaw_decode_np(codes))
    assert got.dtype == np.float32 and got[0] == 0.0
    np.testing.assert_allclose(got, mulaw_decode(torch.from_numpy(codes)).numpy(),
                               rtol=1e-6, atol=0)
    with pytest.raises(TypeError):
        mulaw_decode_np(codes.astype(np.int16))


def test_tick_schedule_raises_where_a_ring_read_would_escape():
    geometry = device_streaming.ring_geometry(CFG, 8000, 64, 8, 64)
    frames_max, emit_max, ring_m, ring_l = geometry
    # Counters whose emission window starts far past the mel ring's end:
    # sed_tpu's dynamic slices clamp such a read, the port refuses it.
    c = {"t_total": 80000, "n_frames": 29, "emitted": 10000, "mel_start": 0}
    jax_streaming.tick_schedule(c, 8000, frames_max, emit_max, ring_m, ring_l,
                                JCFG, 8, 64)
    with pytest.raises(ValueError, match="escape their rings"):
        streaming.tick_schedule(c, 8000, frames_max, emit_max, ring_m, ring_l,
                                CFG, 8, 64)


# -- K3 and logmel_frames ---------------------------------------------------

def frames(dtype, rows=11, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(CFG.nfft) / CFG.working_sample_rate
    x = 0.3 * rng.standard_normal((rows, CFG.nfft))
    x += 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(1, rows + 1)[:, None] * t)
    x[3] = 0.0
    x[4] *= 1e-3
    x = np.clip(x, -1, 1)
    if dtype == "int16":
        return (x * 32767).astype(np.int16)
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_k3_plain_energy_matches_stft_power_pallas(dtype):
    x = frames(dtype)
    window = kernels.stft_window(CFG, torch.device("cpu"))
    power = kernels.frames_stft_power(torch.from_numpy(x), window, CFG.nfft)
    assert power.shape == (len(x), CFG.freq_bins) and power.dtype == torch.float32
    p = power.double().numpy()
    # One-sided -> all n_fft bins: DC and Nyquist once, the others twice.
    got = p[:, 0] + p[:, -1] + 2 * p[:, 1:-1].sum(axis=1)
    want = np.asarray(stft_power_pallas(jnp.asarray(x), JCFG, interpret=True),
                      np.float64).sum(axis=1)
    assert got[3] == want[3] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_logmel_frames_matches_logmel_frames_pallas(dtype):
    x = frames(dtype, seed=1)
    kernels.reset_launch_counts()
    got = logmel_frames(torch.from_numpy(x), CFG).numpy()
    assert kernels.LAUNCHES == {"wave_stft_power": 0, "mel_log": 0,
                                "frames_stft_power": 0, "wave_stft_mel_log": 0,
                                "wave_packed_fft": 0}
    want = np.asarray(logmel_frames_pallas(jnp.asarray(x), JCFG, interpret=True))
    assert got.shape == want.shape == (len(x), CFG.mel_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_int16_frames_equal_their_float_dequantization():
    x = frames("int16", seed=2)
    window = kernels.stft_window(CFG, torch.device("cpu"))
    a = kernels.frames_stft_power(torch.from_numpy(x), window, CFG.nfft)
    b = kernels.frames_stft_power(torch.from_numpy(x.astype(np.float32) / 32768.0),
                                  window, CFG.nfft)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


# -- detectors --------------------------------------------------------------

def audio(batch, seconds, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, seconds * CFG.working_sample_rate))
            ).astype(np.float32)


def assert_pushes_match(got, want):
    """Per-push blocks: identical emission counts, scores within ATOL."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"push {i}")


@pytest.mark.parametrize("chunk", [8000, 2800])
def test_batched_detector_matches_sed_tpu(models, chunk):
    flax_model, params, stats, port = models
    ys = audio(2, 30, seed=chunk)
    rng = np.random.default_rng(3)
    mean = rng.uniform(-60, -40, 64).astype(np.float32)
    std = rng.uniform(5, 15, 64).astype(np.float32)
    ref = jax_streaming.BatchedStreamingDetector(flax_model, params, stats, JCFG,
                                                 batch=2, mean=mean, std=std, **KW)
    det = streaming.BatchedStreamingDetector(port, CFG, batch=2, mean=mean, std=std,
                                             device="cpu", **KW)
    got, want = [], []
    for i in range(0, ys.shape[1], chunk):
        got.append(det.push(ys[:, i:i + chunk]))
        want.append(ref.push(ys[:, i:i + chunk]))
    got.append(det.flush())
    want.append(ref.flush())
    assert_pushes_match(got, want)
    assert sum(g.shape[1] for g in got) == 8 * ((1 + ys.shape[1] // CFG.hop_size) // 8)


def test_single_stream_detector_matches_sed_tpu(models):
    flax_model, params, stats, port = models
    y = audio(1, 20, seed=5)[0]
    ref = jax_streaming.StreamingDetector(flax_model, params, stats, JCFG, **KW)
    det = streaming.StreamingDetector(port, CFG, device="cpu", **KW)
    pieces = np.split(y, [1234, 9000, 30001, 64000, 100000])
    got = [det.push(p) for p in pieces] + [det.flush()]
    want = [ref.push(p) for p in pieces] + [ref.flush()]
    assert_pushes_match(got, want)


@pytest.mark.parametrize("dtype,extract_impl", [("float32", "slices"),
                                                ("int16", "span")])
def test_device_detector_matches_sed_tpu(models, dtype, extract_impl):
    flax_model, params, stats, port = models
    chunk = CFG.working_sample_rate
    ys = audio(2, 40, seed=7)
    if dtype == "int16":
        ys = (ys * 32768.0).astype(np.int16)
    ref = jax_device_streaming.DeviceStreamingDetector(
        flax_model, params, stats, JCFG, batch=2, chunk_samples=chunk,
        extract_impl=extract_impl, **KW)
    det = device_streaming.DeviceStreamingDetector(
        port, CFG, batch=2, chunk_samples=chunk, extract_impl=extract_impl,
        device="cpu", **KW)
    kernels.reset_launch_counts()
    got, want = [], []
    for i in range(0, ys.shape[1], chunk):
        got.append(det.push(ys[:, i:i + chunk]))
        want.append(ref.push(ys[:, i:i + chunk]))
    got.append(det.flush())
    want.append(ref.flush())
    assert det._device_mode and det._closed   # ticked on the rings, then flushed
    assert_pushes_match(got, want)
    assert sum(kernels.LAUNCHES.values()) == 0           # CPU: plain versions


def test_device_detector_mulaw_chunks_equal_their_host_decode(models):
    """uint8 µ-law chunks are decoded on the host during startup and on the
    device in the tick; both equal feeding the decoded float32 audio."""
    from sed_tpu_torch.ops.mulaw import mulaw_decode_np, mulaw_encode

    port = models[3]
    u8 = mulaw_encode(audio(2, 12, seed=9))
    kw = dict(batch=2, chunk_samples=8000, device="cpu", **KW)
    outs = []
    for ys in (u8, mulaw_decode_np(u8)):
        det = device_streaming.DeviceStreamingDetector(port, CFG, **kw)
        blocks = [det.push(ys[:, i:i + 8000]) for i in range(0, ys.shape[1], 8000)]
        assert det._device_mode
        outs.append(np.concatenate(blocks + [det.flush()], axis=1))
    assert outs[0].shape == outs[1].shape
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=ATOL)


def test_device_detector_validation(models):
    port = models[3]
    det = device_streaming.DeviceStreamingDetector(port, CFG, batch=2,
                                                   chunk_samples=8000,
                                                   device="cpu", **KW)
    with pytest.raises(ValueError, match="lockstep"):
        det.push(np.zeros((2, 4000), np.float32))
    det.push(np.zeros((2, 8000), np.float32))
    det.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        det.push(np.zeros((2, 8000), np.float32))


def test_unported_options_raise(models):
    port = models[3]
    assert device_streaming.resolve_tick_featurizer("xla", CFG) == "xla"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        device_streaming.resolve_tick_featurizer("auto", CFG, mesh=object())
    with pytest.raises(ValueError):
        device_streaming.resolve_tick_featurizer("bogus", CFG)
    assert device_streaming.resolve_tick_featurizer("auto", CFG) == "pallas"
    assert device_streaming.resolve_tick_featurizer("pallas", CFG) == "pallas"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        streaming.BatchedStreamingDetector(port, CFG, qparams={}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        device_streaming.DeviceStreamingDetector(port, CFG, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="receptive field"):
        streaming.BatchedStreamingDetector(port, CFG, halo=8, device="cpu")


def test_cuda_device_is_never_silently_replaced(models):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming.StreamingDetector(models[3], CFG)

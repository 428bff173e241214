"""int8 serving through the port's streaming stack and CLIs against sed_tpu's
(CPU): ``make_stream_fns(qparams=...)``, the spectrogram detectors,
``DeviceStreamingDetector``, ``StreamPool``, ``make_m5_score_fn`` and both
M5 pools; ``cli.infer``, ``cli.stream`` and ``cli.serve_socket`` with
``--quantize int8``.

The pools and detectors run at 8 kHz on sed_tpu's artifact carried across
by ``models.convert.qparams_from_flax``; the CLIs run in-process beside
sed_tpu's on one sed_tpu ``.ckpt`` per arch (seeded weights and BatchNorm
statistics) and the same seeded 48 kHz WAVs, each package calibrating its
own artifact.  Tolerances (sed_tpu's own): port against sed_tpu within 5e-3
(the band between sed_tpu's two int8 graphs, tests/test_streaming.py
:186-191); a pool slot against a fresh detector within 1e-5
(tests/test_stream_pool.py:464-490); M5 streamed against offline int8
within 1e-6 (tests/test_waveform_streaming.py:83-103); refusals exit with
sed_tpu's message.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_ckpt_convert as ckpt_tests
from sed_tpu import stream_pool as jax_pool
from sed_tpu import streaming as jax_streaming
from sed_tpu import waveform_streaming as jax_ws
from sed_tpu.cli import infer as jax_infer_cli
from sed_tpu.cli import serve_socket as jax_socket_cli
from sed_tpu.cli import stream as jax_stream_cli
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data.events import frame_coverage_labels
from sed_tpu.io.audio import read_multichannel_audio as jax_read
from sed_tpu.models import quantize as jq
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.ops.featurizer import logmel_features as jax_logmel
from sed_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sed_tpu_torch import device_streaming, streaming
from sed_tpu_torch import waveform_streaming as ws
from sed_tpu_torch.cli import infer as infer_cli
from sed_tpu_torch.cli import serve_socket as socket_cli
from sed_tpu_torch.cli import stream as stream_cli
from sed_tpu_torch.cli.infer import hop_frames
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          qparams_from_flax)
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.models.quantize import quantized_m5_forward
from sed_tpu_torch.stream_pool import StreamPool

SMALL = dict(working_sample_rate=8000, time_margin=0.33)
CFG, JCFG = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
WCFG, JWCFG = WaveformConfig(**SMALL), JaxWaveformConfig(**SMALL)
CHUNK = 8000
KW = dict(halo=64, total_stride=8, bucket=64)
BAND = 5e-3       # port against sed_tpu
SLOT_TOL = 1e-5   # a pool slot against a fresh detector
M5_TOL = 1e-6     # M5 streamed against offline int8
SR = 48000
LENGTHS = (6 * SR + 1234, 5 * SR, 4 * SR + 777)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def joined(blocks, classes=1):
    blocks = [b for b in blocks if b.shape[0]]
    return np.concatenate(blocks) if blocks else np.zeros((0, classes), np.float32)


@pytest.fixture(scope="module")
def cnn():
    """(flax model, params, stats, port model, sed_tpu's int8 artifact, the
    port's copy of it) at 8 kHz, calibrated on a batch of log-mel windows."""
    flax_model = FlaxCnn(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL)
    calib = np.random.default_rng(13).standard_normal(
        (2, CFG.train_crop_size, CFG.mel_bins, 1)).astype(np.float32)
    variables = jax.jit(lambda k, v: flax_model.init(k, v, train=False))(
        jax.random.key(0), jnp.asarray(calib))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    q = jq.quantize_cnn(flax_model, params, stats, [calib])
    return flax_model, params, stats, port, q, qparams_from_flax(jax.tree.map(np.asarray, q))


@pytest.fixture(scope="module")
def m5():
    flax_model = FlaxM5(classes_num=1)
    sample = jnp.zeros((1, JWCFG.frame_size, 1))
    variables = jax.jit(lambda k, v: flax_model.init(k, v, train=False))(
        jax.random.key(1), sample)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = M5(1)
    port.load_state_dict(m5_state_dict(params, stats), strict=True)
    wav = (0.1 * np.random.default_rng(2).standard_normal(4 * JWCFG.frame_size)).astype(
        np.float32)
    frames, _ = frame_coverage_labels(wav[None], [], [], JWCFG)
    q = jq.quantize_m5(flax_model, params, stats, [np.transpose(frames, (0, 2, 1))])
    return flax_model, params, stats, port, q, qparams_from_flax(jax.tree.map(np.asarray, q))


# ---------------------------------------------------------------------------
# The library seams
# ---------------------------------------------------------------------------


def test_stream_fns_detector_and_pool_follow_sed_tpu(cnn):
    """The same artifact: ``make_stream_fns``' forward, a detector's pushes
    and a pool slot's ticks within 5e-3 of sed_tpu's int8 detector with the
    same emission counts, and the pool slot within 1e-5 of the port's fresh
    int8 detector."""
    flax_model, params, stats, port, q, qp = cnn
    audio = (0.1 * np.random.default_rng(13).standard_normal((12, CHUNK))).astype(np.float32)
    window = np.random.default_rng(3).standard_normal((2, 64, CFG.mel_bins)).astype(np.float32)
    _, j_forward = jax_streaming.make_stream_fns(flax_model, params, stats, JCFG, qparams=q)
    _, forward = streaming.make_stream_fns(port, CFG, qparams=qp, device="cpu")
    np.testing.assert_allclose(forward(torch.from_numpy(window)[:, None]).numpy(),
                               np.asarray(j_forward(jnp.asarray(window[..., None]))),
                               rtol=0, atol=BAND)

    jdet = jax_streaming.BatchedStreamingDetector(flax_model, params, stats, JCFG, batch=1,
                                                  qparams=q, **KW)
    want = [jdet.push(c[None])[0] for c in audio] + [jdet.flush()[0]]
    det = streaming.StreamingDetector(port, CFG, qparams=qp, device="cpu", **KW)
    got = [det.push(c) for c in audio] + [det.flush()]
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(joined(got), joined(want), rtol=0, atol=BAND)

    pool = StreamPool(port, CFG, slots=2, chunk_samples=CHUNK, qparams=qp, device="cpu",
                      **KW)
    s = pool.join()
    pooled = [pool.push({s: c})[s] for c in audio] + [pool.leave(s)]
    assert [g.shape for g in pooled] == [w.shape for w in want]
    np.testing.assert_allclose(joined(pooled), joined(got), rtol=0, atol=SLOT_TOL)

    jpool = jax_pool.StreamPool(flax_model, params, stats, JCFG, slots=2, chunk_samples=CHUNK,
                                qparams=q, **KW)
    js = jpool.join()
    jpooled = [jpool.push({js: c})[js] for c in audio] + [jpool.leave(js)]
    np.testing.assert_allclose(joined(pooled), joined(jpooled), rtol=0, atol=BAND)


def test_device_streaming_detector_int8_equals_the_host_detector(cnn):
    """``DeviceStreamingDetector`` (the ring tick) with qparams: the port's
    host int8 detector within 1e-5, on two lockstep streams."""
    _, _, _, port, _, qp = cnn
    audio = (0.1 * np.random.default_rng(4).standard_normal((10, 2, CHUNK))).astype(np.float32)
    dev = device_streaming.DeviceStreamingDetector(port, CFG, batch=2, chunk_samples=CHUNK,
                                                   qparams=qp, device="cpu", **KW)
    host = streaming.BatchedStreamingDetector(port, CFG, batch=2, qparams=qp, device="cpu",
                                              **KW)
    got = [dev.push(c) for c in audio]
    assert dev._device_mode, "the detector reached its device rings"
    got.append(dev.flush())
    want = [host.push(c) for c in audio] + [host.flush()]
    for b in range(2):
        g = joined([x[b] for x in got])
        w = joined([x[b] for x in want])
        assert g.shape == w.shape and g.shape[0] > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=SLOT_TOL)


def test_m5_score_fn_detectors_and_pools_follow_sed_tpu(m5):
    """The same M5 artifact: ``make_m5_score_fn`` within 5e-3 of sed_tpu's;
    the detector and both pools equal to the port's offline int8 scoring of
    the frames (1e-6), and within 5e-3 of sed_tpu's int8 detector."""
    flax_model, params, stats, port, q, qp = m5
    wav = (0.1 * np.random.default_rng(2).standard_normal(3 * CHUNK + 1111)).astype(
        np.float32)
    frames = hop_frames(torch.from_numpy(wav)[:, None], WCFG)
    offline = torch.sigmoid(quantized_m5_forward(qp, frames)).numpy()
    score = ws.make_m5_score_fn(port, qparams=qp, device="cpu")
    np.testing.assert_allclose(score(frames[:, 0]).numpy(), offline, rtol=0, atol=M5_TOL)
    jdet = jax_ws.WaveformStreamingDetector(flax_model, params, stats, JWCFG, qparams=q)
    want = joined([jdet.push(wav[p:p + 7000]) for p in range(0, len(wav), 7000)])
    np.testing.assert_allclose(offline, want, rtol=0, atol=BAND)

    det = ws.WaveformStreamingDetector(port, WCFG, qparams=qp, device="cpu")
    got = joined([det.push(wav[p:p + 7000]) for p in range(0, len(wav), 7000)])
    np.testing.assert_allclose(got, offline, rtol=0, atol=M5_TOL)
    for pool in (ws.WaveformStreamPool(port, WCFG, slots=2, qparams=qp, device="cpu"),
                 ws.DeviceWaveformStreamPool(port, WCFG, slots=2, chunk_samples=CHUNK,
                                             qparams=qp, device="cpu")):
        s = pool.join()
        outs = []
        for p in range(0, len(wav), 5000):
            pool.feed(s, (wav[p:p + 5000] * 32768).round().astype(np.int16))
            outs.append(pool.tick().get(s, np.zeros((0, 1), np.float32)))
        outs.append(pool.leave(s))
        pcm = hop_frames(torch.from_numpy((wav * 32768).round().astype(np.int16)
                                          .astype(np.float32) / 32768.0)[:, None], WCFG)
        want_pcm = torch.sigmoid(quantized_m5_forward(qp, pcm)).numpy()
        np.testing.assert_allclose(joined(outs), want_pcm, rtol=0, atol=M5_TOL,
                                   err_msg=type(pool).__name__)


# ---------------------------------------------------------------------------
# The CLIs, beside sed_tpu's, on one .ckpt per arch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded 48 kHz WAVs (two of them ~5 s, one too short for an M5
    frame), a sed_tpu .ckpt per arch and normalization statistics."""
    root = tmp_path_factory.mktemp("int8")
    wavs = []
    for i, n in enumerate(LENGTHS):
        path = root / f"clip{i}.wav"
        wavfile.write(path, SR, (3000 * np.random.default_rng(i).standard_normal(n))
                      .astype(np.int16))
        wavs.append(str(path))
    wavfile.write(root / "short.wav", SR, np.zeros(SR // 2, np.int16))
    ckpts = {}
    for seed, arch in enumerate(("CnnAvgPooling", "MobileNetV1", "M5")):
        _, state = ckpt_tests.seeded_state(arch, seed=seed, step=3)
        ckpts[arch] = jax_save_checkpoint(state, str(root / arch), 3)
    cfg = JaxSpectrogramConfig()
    feats = np.asarray(jax_logmel(jnp.asarray(jax_read(wavs[1], target_fs=SR, cfg=cfg)), cfg))
    with open(root / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": feats.mean(axis=(0, 1)), "std": feats.std(axis=(0, 1))}, f)
    return root, wavs, ckpts, str(root / "mean_std.pkl")


def cli_args(files, arch):
    root, _, ckpts, mean_std = files
    args = ["--ckpt", ckpts[arch], "--arch", arch, "--device", "cpu", "--quantize", "int8"]
    return args + (["--mean_std_file", mean_std] if arch != "M5" else [])


ARCHS = ["CnnAvgPooling", "MobileNetV1", "M5"]


@pytest.mark.parametrize("arch", ARCHS)
def test_infer_cli_int8_follows_sed_tpu(arch, files, tmp_path):
    """``cli.infer --quantize int8`` on one file: each package calibrates on
    the file's own features (frames for M5); scores within 5e-3.  The file
    is the stream CLI's first, whose calibration batch then has the shape
    sed_tpu's eager calibration sweep has compiled for already."""
    _, wavs, _, _ = files
    out = {}
    for name, main in (("ours", infer_cli.main), ("theirs", jax_infer_cli.main)):
        out[name] = tmp_path / name
        main([wavs[0], *cli_args(files, arch), "--no_plot", "--outputs_dir", str(out[name])])
    ours, theirs = (np.load(out[k] / "clip0_scores.npy") for k in ("ours", "theirs"))
    assert ours.shape == theirs.shape and ours.shape[0] > 0
    print(f"{arch}: cli.infer int8, port vs sed_tpu max {np.abs(ours - theirs).max():.3e}")
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=BAND)


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_cli_int8_follows_sed_tpu(arch, files, tmp_path, capsys):
    """``cli.stream --quantize int8`` on three files over two slots: both
    packages calibrate on the first file; every file within 5e-3."""
    _, wavs, _, _ = files
    outs = {}
    for name, main in (("ours", stream_cli.main), ("theirs", jax_stream_cli.main)):
        out = tmp_path / name
        main([*wavs, *cli_args(files, arch), "--outputs_dir", str(out), "--slots", "2",
              "--stagger_ticks", "1"])
        outs[name] = [np.load(out / f"clip{i}_scores.npy") for i in range(len(wavs))]
    assert f"int8 serving mode: activation scales calibrated on {wavs[0]}" in \
        capsys.readouterr().err
    for i, (a, b) in enumerate(zip(outs["ours"], outs["theirs"])):
        assert a.shape == b.shape and a.shape[0] > 0, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=BAND, err_msg=f"clip{i}")


REFUSALS = {
    "infer-bf16": ("infer", "CnnAvgPooling", ["--bf16"]),
    "stream-bf16": ("stream", "CnnAvgPooling", ["--bf16"]),
    "socket-bf16": ("serve_socket", "CnnAvgPooling", ["--bf16"]),
    "socket-mobilenet": ("serve_socket", "MobileNetV1", []),
    "socket-no-calib": ("serve_socket", "CnnAvgPooling", []),
    "socket-short-calib": ("serve_socket", "M5", ["--calib_wav", "SHORT"]),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_int8_refusals_match_sed_tpu(case, files):
    """Every int8 refusal exits with sed_tpu's own message: --bf16 beside
    --quantize in the three CLIs, MobileNetV1 on the socket, a missing
    --calib_wav, and one too short for an M5 frame."""
    root, wavs, _, _ = files
    which, arch, extra = REFUSALS[case]
    extra = [str(root / "short.wav") if e == "SHORT" else e for e in extra]
    args = [*cli_args(files, arch), *extra]
    if which != "serve_socket":
        args = [wavs[0], *args]
    mains = {"infer": (infer_cli.main, jax_infer_cli.main),
             "stream": (stream_cli.main, jax_stream_cli.main),
             "serve_socket": (socket_cli.main, jax_socket_cli.main)}[which]
    messages = []
    for main in mains:
        with pytest.raises(SystemExit) as exc:
            main(args)
        messages.append(str(exc.value.code))
    assert messages[0] == messages[1]

"""The bf16 tier on the port's live paths against sed_tpu's (CPU).

``StreamPool``, ``DeviceStreamingDetector`` (CnnAvgPooling and MobileNetV1's
logits view) and both M5 pools, each with a bfloat16-compute model
(``dtype=torch.bfloat16``: float32 weights and BatchNorm statistics, the
featurizer, normalization and carried state in float32), against
``sed_tpu``'s pools with its ``dtype=jnp.bfloat16`` models on the same
weights and chunks, and against the port's own float32 pools; then
``cli.stream --bf16`` and ``cli.serve_socket --bf16`` in-process beside
``sed_tpu``'s CLIs on one ``sed_tpu`` ``.ckpt``.

Tolerances: scores within 0.05 of sed_tpu's bf16 and of the float32 tier
(``sed_tpu``'s band for the tier, tests/test_stream_pool.py:737), with the
same block shapes; the socket server's MobileNetV1 under ``--bf16`` scores
in float32, as sed_tpu's does (tests/test_torch_stream_archs.py's 1e-5).
Pools and detectors run at 8 kHz with seeded weights and BatchNorm
statistics; the CLIs at 48 kHz on a few seconds of audio.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_ckpt_convert as ckpt_tests
from test_torch_stream_archs import serve
from sed_tpu import device_streaming as jax_device_streaming
from sed_tpu import serve_socket as jax_server
from sed_tpu import stream_pool as jax_pool
from sed_tpu import waveform_streaming as jax_ws
from sed_tpu.cli import serve_socket as jax_socket_cli
from sed_tpu.cli import stream as jax_stream_cli
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sed_tpu_torch import device_streaming
from sed_tpu_torch import serve_socket as server
from sed_tpu_torch import waveform_streaming as ws
from sed_tpu_torch.cli import serve_socket as socket_cli
from sed_tpu_torch.cli import stream as stream_cli
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          mobilenet_state_dict)
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.stream_pool import StreamPool

SMALL = dict(working_sample_rate=8000, time_margin=0.33)
CFG, JCFG = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
WCFG, JWCFG = WaveformConfig(**SMALL), JaxWaveformConfig(**SMALL)
CHUNK = 8000
BAND = 0.05       # bf16 against sed_tpu's bf16, and against float32
F32_TOL = 1e-5    # a float32 path against sed_tpu's float32 path
SR = 48000
LENGTHS = (4 * SR + 1234, 5 * SR, 3 * SR + 777)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def joined(blocks, classes=1):
    blocks = [b for b in blocks if b.shape[0]]
    return np.concatenate(blocks) if blocks else np.zeros((0, classes), np.float32)


def seeded(flax_model, sample, seed):
    """flax init with every BatchNorm scale, bias and statistic drawn from
    ``seed``, so the bf16 rounding shows in the scores."""
    variables = jax.jit(lambda k, v: flax_model.init(k, v, train=False))(
        jax.random.key(seed), sample)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3), "mean": (-0.05, 0.05),
                  "var": (0.5, 2.0)}.get(path[-1].key, (None, None))
        a = np.asarray(a)
        return a if lo is None else rng.uniform(lo, hi, a.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(draw, variables["params"]),
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]))


FAMILIES = {
    # flax module of a dtype, port module of a dtype, converter, init sample, halo
    "CnnAvgPooling": (lambda d: FlaxCnn(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL,
                                        dtype=d),
                      lambda d: CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, dtype=d),
                      cnn_avg_pooling_state_dict, (1, 32, 64, 1), 64),
    "MobileNetV1": (lambda d: FlaxMobileNetV1(classes_num=1, emit="logits", dtype=d),
                    lambda d: MobileNetV1(1, emit="logits", dtype=d),
                    mobilenet_state_dict, (1, 32, 64, 1), 88),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def spec(request):
    """(arch, {tier: (flax model, port model)}, params, stats, halo)."""
    flax_of, port_of, convert, sample, halo = FAMILIES[request.param]
    params, stats = seeded(flax_of(jnp.float32), jnp.zeros(sample), 7)
    models = {}
    for tier, jd, td in (("f32", jnp.float32, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        port = port_of(td)
        port.load_state_dict(convert(params, stats), strict=True)
        models[tier] = (flax_of(jd), port)
    return request.param, models, params, stats, halo


def audio_chunks(seed, n=14, streams=2):
    rng = np.random.default_rng(seed)
    return (3000 * rng.standard_normal((n, streams, CHUNK))).astype(np.int16)


def run_pool(pool, audio):
    """Feed each stream its chunk a tick, then leave: per stream the scores
    and the block shapes."""
    slots = [pool.join() for _ in range(audio.shape[1])]
    blocks = {s: [] for s in slots}
    for chunk in audio:
        for s, c in zip(slots, chunk):
            pool.feed(s, c)
        for s, sc in pool.tick().items():
            blocks[s].append(sc)
    for s in slots:
        blocks[s].append(pool.leave(s))
    return [(joined(blocks[s]), [b.shape for b in blocks[s]]) for s in slots]


def assert_streams_close(got, want, tol, what):
    for i, ((g, g_shapes), (w, w_shapes)) in enumerate(zip(got, want)):
        assert g_shapes == w_shapes, (what, i)
        assert g.shape == w.shape and g.shape[0] > 0, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what} stream {i}")


def test_stream_pool_bf16_follows_sed_tpu_and_float32(spec):
    """``StreamPool`` with the bf16 model: within 0.05 of sed_tpu's bf16
    pool and of the port's float32 pool, block for block; the float32 pools
    of both packages within 1e-5 (the weights carried over)."""
    arch, models, params, stats, halo = spec
    audio = audio_chunks(3)
    kw = dict(slots=2, chunk_samples=CHUNK, halo=halo, total_stride=8, bucket=64)
    runs = {}
    for tier, (flax_model, port) in models.items():
        runs["port", tier] = run_pool(StreamPool(port, CFG, device="cpu", **kw), audio)
        runs["sed_tpu", tier] = run_pool(
            jax_pool.StreamPool(flax_model, params, stats, JCFG, **kw), audio)
    dev = max(float(np.abs(g - w).max()) for (g, _), (w, _) in
              zip(runs["port", "bf16"], runs["sed_tpu", "bf16"]))
    f32_dev = max(float(np.abs(g - w).max()) for (g, _), (w, _) in
                  zip(runs["port", "bf16"], runs["port", "f32"]))
    print(f"{arch} StreamPool bf16: port vs sed_tpu {dev:.3e}, port bf16 vs f32 {f32_dev:.3e}")
    assert_streams_close(runs["port", "f32"], runs["sed_tpu", "f32"], F32_TOL, "float32")
    assert_streams_close(runs["port", "bf16"], runs["sed_tpu", "bf16"], BAND, "bf16 vs sed_tpu")
    assert_streams_close(runs["port", "bf16"], runs["port", "f32"], BAND, "bf16 vs float32")
    assert f32_dev > 0, "the bf16 pool computes in bfloat16"


def test_device_streaming_detector_bf16_follows_sed_tpu_and_float32(spec):
    """``DeviceStreamingDetector`` (the ring tick) with the bf16 model on two
    lockstep streams: within 0.05 of sed_tpu's bf16 detector and of the
    port's float32 detector, and its rings stay float32."""
    arch, models, params, stats, halo = spec
    audio = (audio_chunks(5, n=12) / 32768.0).astype(np.float32)
    kw = dict(batch=2, chunk_samples=CHUNK, halo=halo, total_stride=8, bucket=64)
    out = {}
    for tier, (flax_model, port) in models.items():
        det = device_streaming.DeviceStreamingDetector(port, CFG, device="cpu", **kw)
        got = [det.push(c) for c in audio]
        assert det._device_mode, "the detector reached its device rings"
        assert det._buf.dtype == det._mel.dtype == torch.float32
        got.append(det.flush())
        jdet = jax_device_streaming.DeviceStreamingDetector(flax_model, params, stats, JCFG,
                                                            **kw)
        want = [jdet.push(c) for c in audio] + [jdet.flush()]
        out[tier] = [(joined([x[b] for x in got]), [x[b].shape for x in got]) for b in range(2)]
        out["sed_tpu", tier] = [(joined([np.asarray(x[b]) for x in want]),
                                 [np.asarray(x[b]).shape for x in want]) for b in range(2)]
    assert_streams_close(out["f32"], out["sed_tpu", "f32"], F32_TOL, "float32")
    assert_streams_close(out["bf16"], out["sed_tpu", "bf16"], BAND, "bf16 vs sed_tpu")
    assert_streams_close(out["bf16"], out["f32"], BAND, "bf16 vs float32")


@pytest.fixture(scope="module")
def m5():
    """{tier: (flax M5, port M5)}, params, stats: seeded weights at 8 kHz."""
    params, stats = seeded(FlaxM5(classes_num=1), jnp.zeros((1, JWCFG.frame_size, 1)), 9)
    models = {}
    for tier, jd, td in (("f32", jnp.float32, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        port = M5(1, dtype=td)
        port.load_state_dict(m5_state_dict(params, stats), strict=True)
        models[tier] = (FlaxM5(classes_num=1, dtype=jd), port)
    return models, params, stats


@pytest.mark.parametrize("which", ["device", "host"])
def test_m5_pools_bf16_follow_sed_tpu_and_float32(m5, which):
    """Both M5 pools with a bf16 M5 (``make_m5_score_fn``): within 0.05 of
    sed_tpu's bf16 pool of the same kind and of the port's float32 pool."""
    models, params, stats = m5
    audio = audio_chunks(11, n=6, streams=3)
    runs = {}
    for tier, (flax_model, port) in models.items():
        if which == "device":
            ours = ws.DeviceWaveformStreamPool(port, WCFG, slots=3, chunk_samples=CHUNK,
                                               device="cpu")
            theirs = jax_ws.DeviceWaveformStreamPool(flax_model, params, stats, JWCFG,
                                                     slots=3, chunk_samples=CHUNK)
        else:
            ours = ws.WaveformStreamPool(port, WCFG, slots=3, device="cpu")
            theirs = jax_ws.WaveformStreamPool(flax_model, params, stats, JWCFG, slots=3)
        runs["port", tier] = run_pool(ours, audio)
        runs["sed_tpu", tier] = run_pool(theirs, audio)
    score = ws.make_m5_score_fn(models["bf16"][1], device="cpu")
    frames = torch.from_numpy(audio[:2, 0].reshape(-1)[: 2 * WCFG.frame_size].astype(np.float32)
                              .reshape(2, -1) / 32768.0)
    assert score(frames).dtype == torch.float32
    assert_streams_close(runs["port", "f32"], runs["sed_tpu", "f32"], F32_TOL, "float32")
    assert_streams_close(runs["port", "bf16"], runs["sed_tpu", "bf16"], BAND, "bf16 vs sed_tpu")
    assert_streams_close(runs["port", "bf16"], runs["port", "f32"], BAND, "bf16 vs float32")


# ---------------------------------------------------------------------------
# The CLIs, beside sed_tpu's, on one .ckpt per arch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded 48 kHz int16 WAVs and a sed_tpu .ckpt per arch."""
    root = tmp_path_factory.mktemp("bf16_cli")
    wavs = []
    for i, n in enumerate(LENGTHS):
        path = root / f"clip{i}.wav"
        wavfile.write(path, SR, (3000 * np.random.default_rng(20 + i).standard_normal(n))
                      .astype(np.int16))
        wavs.append(str(path))
    ckpts = {}
    for seed, arch in enumerate(("CnnAvgPooling", "MobileNetV1")):
        _, state = ckpt_tests.seeded_state(arch, seed=seed + 4, step=2)
        ckpts[arch] = jax_save_checkpoint(state, str(root / arch), 2)
    return root, wavs, ckpts


def stream_scores(main, files, arch, extra, out):
    _, wavs, ckpts = files
    main([*wavs, "--ckpt", ckpts[arch], "--arch", arch, "--device", "cpu", *extra,
          "--outputs_dir", str(out), "--slots", "2", "--stagger_ticks", "1"])
    return [np.load(out / f"clip{i}_scores.npy") for i in range(len(wavs))]


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1"])
def test_stream_cli_bf16_follows_sed_tpu(arch, files, tmp_path, capsys):
    """``cli.stream --bf16`` on three files over two slots: every file within
    0.05 of sed_tpu's ``--bf16`` run and of the port's float32 run.  Both
    packages score MobileNetV1 in bf16 on this CLI."""
    ours = stream_scores(stream_cli.main, files, arch, ["--bf16"], tmp_path / "ours")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["files"] == 3 and summary["device"] == "cpu"
    f32 = stream_scores(stream_cli.main, files, arch, [], tmp_path / "f32")
    theirs = stream_scores(jax_stream_cli.main, files, arch, ["--bf16"], tmp_path / "theirs")
    assert np.concatenate(ours).std() > 1e-3, "the seeded model's scores vary"
    assert max(float(np.abs(a - b).max()) for a, b in zip(ours, f32)) > 0
    for i, (a, b, c) in enumerate(zip(ours, theirs, f32)):
        assert a.shape == b.shape == c.shape and a.shape[0] > 0, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=BAND, err_msg=f"clip{i} vs sed_tpu")
        np.testing.assert_allclose(a, c, rtol=0, atol=BAND, err_msg=f"clip{i} vs float32")


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1"])
def test_serve_socket_cli_bf16_follows_sed_tpu(arch, files, monkeypatch, capsys):
    """``cli.serve_socket --bf16``, two pcm16 clients on each package's
    server.  CnnAvgPooling within 0.05 of sed_tpu's; MobileNetV1 in float32
    on both servers (sed_tpu rebuilds its logits view without the bf16
    dtype, and the port keeps that), so within 1e-5, with the port's note."""
    _, wavs, ckpts = files
    clips = [wavfile.read(w)[1] for w in wavs[:2]]
    argv = ["--ckpt", ckpts[arch], "--arch", arch, "--device", "cpu", "--bf16", "--slots", "2",
            "--tick_interval", "0.02", "--run_seconds", "1"]
    ours = serve(monkeypatch, socket_cli, server, argv, clips, "pcm16")
    err = capsys.readouterr().err
    theirs = serve(monkeypatch, jax_socket_cli, jax_server, argv, clips, "pcm16")
    monkeypatch.undo()
    tol = F32_TOL if arch == "MobileNetV1" else BAND
    assert ("serves MobileNetV1 in float32" in err) == (arch == "MobileNetV1")
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and a.shape[0] > 0, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"client {i}")


@pytest.mark.parametrize("which", ["stream", "serve_socket"])
def test_mobilenet_view_dtype_per_cli(which, files):
    """The shared ``build_pool``: under ``--bf16`` the stream CLI's
    MobileNetV1 view computes in bfloat16, the socket server's in float32,
    each as its sed_tpu counterpart; CnnAvgPooling is bf16 on both."""
    _, wavs, ckpts = files
    cli = stream_cli if which == "stream" else socket_cli
    notes = []
    for arch in ("MobileNetV1", "CnnAvgPooling"):
        argv = ["--ckpt", ckpts[arch], "--arch", arch, "--device", "cpu", "--bf16"]
        args = cli.build_arg_parser().parse_args(([wavs[0]] if which == "stream" else []) + argv)
        pool = stream_cli.build_pool(args, stream_cli.serving_config(args), 2, SR,
                                     note=notes.append,
                                     mobilenet_bf16=which == "stream")
        want = None if (which, arch) == ("serve_socket", "MobileNetV1") else torch.bfloat16
        assert pool._model.dtype == want, (which, arch)
    assert any("float32" in n for n in notes) == (which == "serve_socket")


@pytest.mark.parametrize("which", ["stream", "serve_socket"])
def test_bf16_with_quantize_is_still_refused(which, files, capsys):
    """``--bf16 --quantize int8`` exits before any work with sed_tpu's
    message, in both CLIs."""
    _, wavs, ckpts = files
    argv = ["--ckpt", ckpts["CnnAvgPooling"], "--device", "cpu", "--bf16", "--quantize", "int8"]
    mains = {"stream": (stream_cli.main, jax_stream_cli.main),
             "serve_socket": (socket_cli.main, jax_socket_cli.main)}[which]
    if which == "stream":
        argv = [wavs[0], *argv]
    messages = []
    kernels.reset_launch_counts()
    for main in mains:
        with pytest.raises(SystemExit) as exc:
            main(argv)
        messages.append(str(exc.value.code))
    assert messages[0] == messages[1] and "mutually exclusive" in messages[0]
    assert not any(kernels.LAUNCHES.values())

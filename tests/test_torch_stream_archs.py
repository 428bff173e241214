"""The port's live CLIs for MobileNetV1 and M5 against sed_tpu's (CPU).

``python -m sed_tpu_torch.cli.stream`` and ``cli.serve_socket`` run
in-process beside ``sed_tpu``'s CLIs on the same ``sed_tpu`` msgpack
``.ckpt`` (seeded weights and BatchNorm statistics), on a few seconds of
48 kHz audio in three streams: every file's or client's scores within 1e-5
of ``sed_tpu``'s.  Also MobileNetV1's halo floor and its message, and
``--featurizer xla`` against ``auto`` (log-mel within 1e-4 dB, scores
within 1e-5).
"""

import json
import pickle
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_ckpt_convert as ckpt_tests
from sed_tpu.cli import serve_socket as jax_socket_cli
from sed_tpu.cli import stream as jax_stream_cli
from sed_tpu import serve_socket as jax_server
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.device_streaming import resolve_tick_featurizer as jax_resolve_featurizer
from sed_tpu.io.audio import read_multichannel_audio as jax_read
from sed_tpu.ops.featurizer import logmel_features as jax_logmel
from sed_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sed_tpu_torch import serve_socket as server
from sed_tpu_torch.cli import serve_socket as socket_cli
from sed_tpu_torch.cli import stream as stream_cli
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.ops.featurizer import logmel_frames, logmel_frames_xla

SR = 48000
ATOL, DB_TOL = 1e-5, 1e-4
LENGTHS = (4 * SR + 1234, 6 * SR, 5 * SR + 777)
CASES = [("MobileNetV1", []), ("M5", ["--m5_pool", "device"]), ("M5", ["--m5_pool", "host"])]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The three WAVs, each arch's .ckpt, and normalization statistics from
    sed_tpu's log-mel of one file."""
    root = tmp_path_factory.mktemp("archs")
    wavs = []
    for i, n in enumerate(LENGTHS):
        path = root / f"clip{i}.wav"
        y = (3000 * np.random.default_rng(i).standard_normal(n)).astype(np.int16)
        wavfile.write(path, SR, y)
        wavs.append(str(path))
    ckpts = {}
    for seed, arch in enumerate(("MobileNetV1", "M5")):
        _, state = ckpt_tests.seeded_state(arch, seed=seed, step=5)
        ckpts[arch] = jax_save_checkpoint(state, str(root / arch), 5)
    cfg = JaxSpectrogramConfig()
    feats = np.asarray(jax_logmel(jnp.asarray(jax_read(wavs[1], target_fs=SR, cfg=cfg)), cfg))
    with open(root / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": feats.mean(axis=(0, 1)), "std": feats.std(axis=(0, 1))}, f)
    return root, wavs, ckpts, str(root / "mean_std.pkl")


def common_args(files, arch):
    _, _, ckpts, mean_std = files
    args = ["--ckpt", ckpts[arch], "--arch", arch, "--device", "cpu"]
    return args + (["--mean_std_file", mean_std] if arch != "M5" else [])


def run_stream(main, files, arch, extra, out):
    _, wavs, _, _ = files
    main([*wavs, *common_args(files, arch), *extra, "--outputs_dir", str(out),
          "--slots", "2", "--stagger_ticks", "1"])
    return [np.load(out / f"clip{i}_scores.npy") for i in range(len(wavs))]


@pytest.fixture(scope="module")
def theirs_stream(files, tmp_path_factory):
    """sed_tpu's stream CLI scores by ``(arch, *extra)``, each run once per
    module (its jit compiles dominate this file's time)."""
    runs = {}

    def get(arch, extra):
        key = (arch, *extra)
        if key not in runs:
            out = tmp_path_factory.mktemp("theirs")
            runs[key] = run_stream(jax_stream_cli.main, files, arch, extra, out)
        return runs[key]

    return get


@pytest.mark.parametrize("arch, extra", CASES, ids=["MobileNetV1", "M5-device", "M5-host"])
def test_stream_cli_matches_sed_tpu(arch, extra, files, theirs_stream, tmp_path, capsys):
    ours = run_stream(stream_cli.main, files, arch, extra, tmp_path / "ours")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["files"] == 3 and summary["device"] == "cpu"
    assert sum(summary["kernel_launches"].values()) == 0
    theirs = theirs_stream(arch, extra)
    assert np.concatenate(ours).std() > 1e-3, "the seeded model's scores vary"
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and a.shape[0] > 0, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f"clip{i}")


def test_mobilenet_halo_is_raised_to_its_floor_with_the_message(files, tmp_path, capsys):
    run_stream(stream_cli.main, files, "MobileNetV1", ["--halo", "64"], tmp_path / "out")
    assert "halo 64 < receptive field requirement 88; using 88" in capsys.readouterr().err
    parser = stream_cli.build_arg_parser()
    args = parser.parse_args(["a.wav", *common_args(files, "MobileNetV1"), "--halo", "96"])
    pool = stream_cli.build_pool(args, SpectrogramConfig(), 2, SR)
    assert pool.halo == 96 and pool._model.emit == "logits"


def test_featurizer_xla_against_auto(files, theirs_stream, tmp_path, capsys):
    """``logmel_frames_xla`` (PyTorch ops) against K3 + K2's plain versions
    within 1e-4 dB, and the stream CLI's scores with ``--featurizer xla``
    against ``auto`` within 1e-5, and against sed_tpu's ``xla`` tick (its
    ``auto`` on the CPU)."""
    cfg = SpectrogramConfig()
    rng = np.random.default_rng(4)
    rows = torch.from_numpy((3000 * rng.standard_normal((6, cfg.nfft))).astype(np.int16))
    for x in (rows, rows.float() / 32768.0):
        db = (logmel_frames_xla(x, cfg) - logmel_frames(x, cfg)).abs().max()
        assert float(db) <= DB_TOL
    auto = run_stream(stream_cli.main, files, "MobileNetV1", [], tmp_path / "auto")
    xla = run_stream(stream_cli.main, files, "MobileNetV1", ["--featurizer", "xla"],
                     tmp_path / "xla")
    assert jax_resolve_featurizer("auto", JaxSpectrogramConfig()) == "xla"
    theirs = theirs_stream("MobileNetV1", [])
    for a, b, c in zip(auto, xla, theirs):
        assert a.shape == b.shape == c.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
        np.testing.assert_allclose(b, c, rtol=0, atol=ATOL)


def serve(monkeypatch, cli, server_module, argv, clips, wire):
    """Run ``cli.main(argv)`` in a thread, send each clip from its own
    client once the server listens, and stop the CLI when every client has
    its scores.  Returns the clients' scores in order."""
    started, done = [], threading.Event()

    class Recording(server_module.StreamServer):
        def start(self):
            super().start()
            started.append(self)

        def stop(self):
            # sed_tpu's stop() only closes its listener, which leaves the
            # accept thread blocked for the whole 5 s of its join; shutting
            # the listener down first wakes it (the port's stop does so).
            try:
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            super().stop()

    class Clock:   # the CLI's time module: its serving sleep ends with the clients
        time = staticmethod(time.time)
        sleep = staticmethod(lambda seconds: done.wait(300))

    monkeypatch.setattr(server_module, "StreamServer", Recording)
    monkeypatch.setattr(cli, "time", Clock)
    errors = []

    def run():
        try:
            cli.main(argv)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            done.set()

    thread = threading.Thread(target=run)
    thread.start()
    t0 = time.time()
    while not started and not errors and time.time() - t0 < 300:
        time.sleep(0.05)
    results = {}
    if started:
        def client(i, y):
            try:
                c = server_module.StreamClient(*started[0].address, classes_num=1, wire=wire)
                for pos in range(0, len(y), 20000):
                    c.send(y[pos:pos + 20000])
                results[i] = c.finish()
            except Exception as e:  # noqa: BLE001 - reported below
                results[i] = e

        threads = [threading.Thread(target=client, args=(i, y)) for i, y in enumerate(clips)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    done.set()
    thread.join(timeout=300)
    assert not errors, errors
    assert started, "the server started"
    out = [results[i] for i in range(len(clips))]
    for r in out:
        if isinstance(r, Exception):
            raise r
    return out


@pytest.mark.parametrize("arch, extra", CASES, ids=["MobileNetV1", "M5-device", "M5-host"])
def test_serve_socket_cli_matches_sed_tpu(arch, extra, files, monkeypatch, capsys):
    """Two pcm16 clients and a µ-law one on each package's server.  The
    port's JSON line gives the pool's chunk, null for M5's host pool (it
    has none)."""
    _, wavs, _, _ = files
    clips = [wavfile.read(w)[1] for w in wavs]
    got = {}
    for wire, sent in (("pcm16", clips[:2]), ("mulaw", clips[2:])):
        argv = [*common_args(files, arch), *extra, "--slots", "3", "--wire", wire,
                "--tick_interval", "0.02", "--run_seconds", "1"]
        ours = serve(monkeypatch, socket_cli, server, argv, sent, wire)
        info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert info["arch"] == arch and info["wire"] == wire
        assert info["chunk_samples"] == (None if "host" in extra else SR), info
        theirs = serve(monkeypatch, jax_socket_cli, jax_server, argv, sent, wire)
        monkeypatch.undo()
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert a.shape == b.shape and a.shape[0] > 0, (wire, i, a.shape, b.shape)
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f"{wire} {i}")
        got[wire] = ours
    assert np.concatenate(got["pcm16"]).std() > 1e-3, "the seeded model's scores vary"


@pytest.mark.parametrize("m5_pool", ["device", "host"])
def test_warmup_ladder_on_the_m5_pools(m5_pool, files):
    """The serve CLI's warmup drives each M5 pool and leaves it empty: the
    device pool the whole ladder (multi-round blocks included), the host
    pool, which has no chunk, one stream of one-frame pieces."""
    parser = socket_cli.build_arg_parser()
    args = parser.parse_args([*common_args(files, "M5"), "--m5_pool", m5_pool])
    pool = stream_cli.build_pool(args, stream_cli.serving_config(args), 2, SR)
    assert (pool.chunk is None) == (m5_pool == "host")
    assert socket_cli.warmup_pool(pool, "mulaw") > 0
    if m5_pool == "host":
        assert not pool._dets and not pool._staged
    else:
        assert not pool._counters and not pool._staged and not pool._staged_n
    assert pool.join() == 0


def test_detector_checks_mobilenets_receptive_field_as_sed_tpu():
    """MobileNetV1 has no ``model_config``: its receptive field (162 frames)
    still bounds the halo, with sed_tpu's message."""
    from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
    from sed_tpu.streaming import BatchedStreamingDetector as JaxDetector
    from sed_tpu_torch.models.cnn import MobileNetV1
    from sed_tpu_torch.streaming import BatchedStreamingDetector

    with pytest.raises(ValueError) as ours:
        BatchedStreamingDetector(MobileNetV1(1, emit="logits"), halo=64, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxDetector(FlaxMobileNetV1(classes_num=1, emit="logits"), None, None, halo=64)
    assert str(ours.value) == str(theirs.value)
    assert "use halo >= 88" in str(ours.value)
    BatchedStreamingDetector(MobileNetV1(1, emit="logits"), halo=88, device="cpu")

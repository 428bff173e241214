"""sed_tpu_torch's live TCP server against sed_tpu, on the CPU (following
tests/test_serve_socket.py).

Scores received over a connection's lifetime must equal offline scoring of
the same audio by ``sed_tpu`` (a fresh single-stream detector on the same
weights, carried across with ``models/convert.py``): identical frame counts,
scores within 1e-5.  Also the two repaired reference faults: R3 (a drain
that times out frees its slot) and R4 (the CLI's warmup ladder is a function
the CPU tests run), and the ``cli.serve_socket`` entry point.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.streaming import BatchedStreamingDetector as JaxDetector
from sed_tpu.streaming import make_stream_fns
from sed_tpu_torch.cli import serve_socket as cli
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import make_batch_predictor
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.ops.mulaw import mulaw_decode_np, mulaw_encode
from sed_tpu_torch.serve_socket import StreamClient, StreamServer
from sed_tpu_torch.stream_pool import StreamPool

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(working_sample_rate=8000, time_margin=0.33)
CFG, JCFG = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
CHUNK = 8000
KW = dict(chunk_samples=CHUNK, halo=64, total_stride=8, bucket=64)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(flax model, params, batch_stats, port model, sed_tpu's shared
    stream functions) with the same weights."""
    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL)
    variables = flax_model.init(jax.random.key(0),
                                jnp.zeros((1, CFG.train_crop_size, CFG.mel_bins, 1)),
                                train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    return flax_model, params, stats, port, make_stream_fns(flax_model, params, stats, JCFG)


def offline(models, wav_f32):
    """sed_tpu's scores of the whole recording, by its streaming detector
    fed everything at once (equal to its offline pipeline).  The jitted
    functions are shared, so repeated shapes compile once."""
    flax_model, params, stats, _, fns = models
    det = JaxDetector(flax_model, params, stats, JCFG, batch=1, halo=64,
                      total_stride=8, bucket=64, stream_fns=fns)
    parts = [det.push(wav_f32[None])[0], det.flush()[0]]
    return np.concatenate([p for p in parts if p.shape[0]], axis=0)


def serve(models, slots, **kw):
    pool = StreamPool(models[3], CFG, slots=slots, device="cpu", **KW)
    server = StreamServer(pool, tick_interval=kw.pop("tick_interval", 0.01), **kw)
    server.start()
    return pool, server


def pcm(n, seed):
    return (3000 * np.random.default_rng(seed).standard_normal(n)).astype(np.int16)


def test_server_streams_match_offline(models):
    _, server = serve(models, 2)
    try:
        audio = {"a": pcm(5 * CHUNK + 1717, 0), "b": pcm(3 * CHUNK + 99, 1)}
        results = {}

        def run(name, piece):
            c = StreamClient(*server.address, classes_num=CFG.classes_num)
            for pos in range(0, len(audio[name]), piece):
                c.send(audio[name][pos: pos + piece])
            results[name] = c.finish()

        threads = [threading.Thread(target=run, args=("a", 5000)),
                   threading.Thread(target=run, args=("b", 12345))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for name, y in audio.items():
            ref = offline(models, y.astype(np.float32) / 32768.0)
            assert results[name].shape == ref.shape, name
            np.testing.assert_allclose(results[name], ref, rtol=0, atol=ATOL, err_msg=name)
    finally:
        server.stop()


def test_server_mulaw_wire_matches_offline(models):
    pool, server = serve(models, 2, wire="mulaw")
    try:
        y = pcm(3 * CHUNK + 513, 7)
        c = StreamClient(*server.address, classes_num=1, wire="mulaw")
        for pos in range(0, len(y), 7000):
            c.send(y[pos: pos + 7000])
        got = c.finish()
        ref = offline(models, mulaw_decode_np(mulaw_encode(y)))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        exact = offline(models, y.astype(np.float32) / 32768.0)
        assert float(np.abs(got - exact).max()) < 0.05   # the codec's band
    finally:
        server.stop()
    with pytest.raises(ValueError, match="wire"):
        StreamServer(pool, wire="opus")
    with pytest.raises(ValueError, match="wire"):
        StreamClient("127.0.0.1", 1, wire="opus")


def test_stop_returns_promptly_and_joins_every_thread(models):
    _, server = serve(models, 1)
    c = StreamClient(*server.address)
    c.send(pcm(CHUNK // 2, 4))
    time.sleep(0.2)
    t0 = time.time()
    server.stop()
    assert time.time() - t0 < 3.0
    assert not any(t.is_alive() for t in server._threads)


def test_server_refuses_when_full(models):
    _, server = serve(models, 1)
    try:
        first = StreamClient(*server.address)
        first.send(np.zeros(CHUNK, np.int16))
        time.sleep(0.2)
        second = StreamClient(*server.address)
        with pytest.raises((RuntimeError, ConnectionError)):
            second.send(np.zeros(64, np.int16))
            second.poll()
        wav = pcm(2 * CHUNK, 1)
        first.send(wav)
        out = first.finish()
        ref = offline(models, np.concatenate([np.zeros(CHUNK, np.float32),
                                              wav.astype(np.float32) / 32768.0]))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    finally:
        server.stop()


def test_server_survives_a_fault_during_a_drain(models):
    pool, server = serve(models, 1)
    orig = pool.leave_many
    fail_once = [True]

    def flaky_leave_many(slots):
        if fail_once[0]:
            fail_once[0] = False
            orig(slots)   # free the slots the way a mid-drain fault does
            raise RuntimeError("device fault (simulated)")
        return orig(slots)

    pool.leave_many = flaky_leave_many
    try:
        y = pcm(4 * CHUNK + 500, 11)
        c = StreamClient(*server.address, classes_num=1)
        c.send(y)
        with pytest.raises(ConnectionError):
            c.finish()
        c2 = StreamClient(*server.address, classes_num=1)
        c2.send(y)
        got = c2.finish()
        ref = offline(models, y.astype(np.float32) / 32768.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    finally:
        server.stop()


def test_server_reclaims_slot_when_client_vanishes(models):
    _, server = serve(models, 1)
    try:
        first = StreamClient(*server.address)
        first.send(pcm(3 * CHUNK, 7))
        time.sleep(0.3)
        first._sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                               b"\x01\x00\x00\x00\x00\x00\x00\x00")
        first._sock.close()   # RST instead of an end marker
        deadline, second = time.time() + 20, None
        while time.time() < deadline and second is None:
            try:
                cand = StreamClient(*server.address)
                cand.send(np.zeros(CHUNK, np.int16))
                time.sleep(0.2)
                cand.send(np.zeros(CHUNK, np.int16))
                second = cand.finish()
            except (RuntimeError, ConnectionError):
                time.sleep(0.3)
        assert second is not None, "slot was never reclaimed after the RST"
    finally:
        server.stop()


def test_flooding_client_receives_every_frame(models):
    """A client faster than real time stages its whole stream and ends it at
    once: the drain ticks the backlog through the rings and routes those
    scores to the leaving client before the exact tail."""
    _, server = serve(models, 2, tick_interval=5.0, drain_gather=0.05)
    try:
        y = pcm(24 * CHUNK + 999, 23)
        c = StreamClient(*server.address, classes_num=1)
        c.send(y)
        got = c.finish()
        ref = offline(models, y.astype(np.float32) / 32768.0)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    finally:
        server.stop()


def test_drain_timeout_removes_the_entry_and_frees_the_slot(models):
    """Fault R3: when the reader's wait for its drain gives up, sed_tpu left
    the slot's drain-queue entry behind and the slot leaked.  The port
    removes the entry under the lock and leaves the slot."""
    pool, server = serve(models, 1, drain_gather=0.01, drain_timeout=0.5)
    server._flush_drains_locked = lambda: None   # the drain never happens
    try:
        c = StreamClient(*server.address)
        c.send(pcm(2 * CHUNK, 3))
        c._sock.sendall(b"\x00\x00\x00\x00")        # end of stream
        deadline = time.time() + 20
        while time.time() < deadline and (server._drainq or pool._admitted
                                          or pool._pending):
            time.sleep(0.05)
        assert server._drainq == {}
        assert not pool._admitted and not pool._pending
        with pytest.raises(ConnectionError):         # closed without a tail
            while True:
                if c.poll() is None:
                    break
        assert pool.join() == 0                      # the slot is free again
    finally:
        server.stop()


def test_warmup_ladder_runs_on_cpu_and_leaves_the_pool_empty(models):
    """Fault R4: sed_tpu ran the pre-serve warmup ladder only on
    accelerators, so no CPU test ever ran it.  The port's is a function."""
    for wire in ("pcm16", "mulaw"):
        pool = StreamPool(models[3], CFG, slots=4, device="cpu", **KW)
        pool.profile = {}
        assert cli.warmup_pool(pool, wire) > 0
        assert not pool._admitted and not pool._pending and not pool._staged
        assert pool.profile["pending_rounds"] >= 2
        assert pool.profile["rounds_real"] >= 3 * (StreamPool.ROUNDS_PER_CALL + 1)
        assert pool.join() == 0


CALIB = "<calib.wav>"   # a flag value the test replaces with a seeded WAV


@pytest.mark.parametrize("flags", [["--arch", "M5"], ["--m5_pool", "host"],
                                   ["--featurizer", "xla"],
                                   ["--quantize", "int8", "--calib_wav", CALIB],
                                   ["--arch", "M5", "--quantize", "int8", "--calib_wav", CALIB],
                                   ["--bf16"], ["--featurizer_precision", "fast"],
                                   ["--featurizer_precision", "turbo"]])
def test_cli_options_once_refused_as_unported(flags, tmp_path):
    """Each option this CLI once refused now builds its pool, as ``main``
    does (``cli.stream.build_pool``), and serves a client: M5's device pool
    (the default ``--m5_pool``), ``--m5_pool host`` (no effect on
    CnnAvgPooling, as in sed_tpu), the xla tick featurizer, int8
    serving calibrated on ``--calib_wav`` for CnnAvgPooling and M5, and the
    bf16 tier.  The client's scores equal the pool's offline counterpart
    (int8: offline int8 scoring with the same calibration, within sed_tpu's
    5e-3 band; bf16: offline float32 scoring, within sed_tpu's 0.05 band for
    the tier), and the featurizer tiers (K3t's plain version; offline scoring
    at the same tier, K1t's)."""
    from sed_tpu_torch.cli.infer import build_model, hop_frames, predict_file_m5
    from sed_tpu_torch.cli.stream import (build_pool, calibrate_int8, refuse_unported,
                                          serving_config)
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.models.quantize import quantized_m5_forward, quantized_scores
    from sed_tpu_torch.ops.featurizer import logmel_features_batch
    from scipy.io import wavfile

    calib = pcm(5 * 48000, 8)
    wavfile.write(tmp_path / "calib.wav", 48000, calib)
    flags = [str(tmp_path / "calib.wav") if f == CALIB else f for f in flags]
    parser = cli.build_arg_parser()
    args = parser.parse_args(["--ckpt", str(tmp_path / "model.pth"), "--device", "cpu",
                              *flags])
    refuse_unported(parser, args)
    model = build_model(args.arch, 1)
    model.reset_parameters(torch.Generator().manual_seed(4))
    torch.save({"model": model.state_dict()}, tmp_path / "model.pth")
    cfg = serving_config(args)
    calib_f32 = calib.astype(np.float32) / 32768.0
    pool = build_pool(args, cfg, 2, cfg.working_sample_rate,
                      calib_wav=calib_f32 if args.quantize else None)
    want_pool = "DeviceWaveformStreamPool" if args.arch == "M5" else "StreamPool"
    assert type(pool).__name__ == want_pool
    y = pcm(3 * 48000 + 777, 6)
    srv = StreamServer(pool, tick_interval=0.02)
    srv.start()
    try:
        c = StreamClient(*srv.address, classes_num=1)
        for pos in range(0, len(y), 20000):
            c.send(y[pos: pos + 20000])
        got = c.finish()
    finally:
        srv.stop()
    tol = 0.05 if args.bf16 else ATOL
    if args.quantize:
        tol = 5e-3
        qp = calibrate_int8(model, args.arch, cfg, calib_f32)
        x = torch.from_numpy(y.astype(np.float32) / 32768.0)
        if args.arch == "M5":
            want = torch.sigmoid(quantized_m5_forward(qp, hop_frames(x[:, None], cfg))).numpy()
        else:
            want = quantized_scores(qp, logmel_features_batch(x[None, :, None], cfg)).numpy()[0]
    elif args.arch == "M5":
        wavfile.write(tmp_path / "y.wav", 48000, y)
        want = predict_file_m5(model, str(tmp_path / "y.wav"), WaveformConfig(),
                               device="cpu")
    else:
        want = make_batch_predictor(model, SpectrogramConfig(),
                                    featurizer_precision=args.featurizer_precision,
                                    device="cpu")(y[None, :, None]).numpy()[0]
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_cli_serves_a_client_on_cpu(tmp_path):
    """``python -m sed_tpu_torch.cli.serve_socket --device cpu`` at the
    production configuration: one pcm16 client's scores against offline
    scoring of the same audio."""
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, tmp_path / "model.pth")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sed_tpu_torch.cli.serve_socket", "--device", "cpu",
         "--ckpt", str(tmp_path / "model.pth"), "--slots", "2",
         "--tick_interval", "0.02", "--run_seconds", "120"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["device"] == "cpu" and info["chunk_samples"] == 48000
        y = pcm(3 * 48000 + 777, 5)
        c = StreamClient(info["host"], info["port"], classes_num=1)
        for pos in range(0, len(y), 20000):
            c.send(y[pos: pos + 20000])
        got = c.finish()
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    want = make_batch_predictor(model, SpectrogramConfig(), device="cpu")(
        y[None, :, None]).numpy()[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

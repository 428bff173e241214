"""The port's M5 streaming (``sed_tpu_torch/waveform_streaming.py``) against
sed_tpu's (CPU).

The cases of ``tests/test_waveform_streaming.py``, each run on the port and
on ``sed_tpu`` with the same weights (flax init carried over by
``models.convert.m5_state_dict``) and the same pushes.  Tolerances: the
port's streamed scores within 1e-6 of its own offline split and of each
other, where ``sed_tpu`` pins its own paths at 1e-6 (the device pool at
1e-5, as ``sed_tpu``); the port within 1e-5 of ``sed_tpu``.  An 8 kHz
config keeps M5's frames short (5,280 samples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu import waveform_streaming as jws
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data.events import frame_coverage_labels
from sed_tpu.models.m5 import M5 as JaxM5
from sed_tpu.train.state import make_eval_forward
from sed_tpu_torch import waveform_streaming as ws
from sed_tpu_torch.cli.infer import hop_frames, score_frames_m5
from sed_tpu_torch.configs import WaveformConfig
from sed_tpu_torch.models.convert import m5_state_dict
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.featurizer import ingest_to_f32_np
from sed_tpu_torch.ops.mulaw import mulaw_encode

SR, MARGIN = 8000, 0.33
JCFG = JaxWaveformConfig(working_sample_rate=SR, time_margin=MARGIN)
CFG = WaveformConfig(working_sample_rate=SR, time_margin=MARGIN)
FRAME = CFG.frame_size
SELF_TOL, DEVICE_TOL, SED_TPU_TOL = 1e-6, 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(cfg=JCFG, seed=0):
    """(flax M5, params, batch_stats, the port's M5 with the same weights):
    flax init, every BatchNorm statistic, scale and bias drawn from ``seed``."""
    model = JaxM5(classes_num=1)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(seed), jnp.zeros((1, cfg.frame_size, 1)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name, a = path[-1].key, np.asarray(a)
        lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3), "mean": (-0.05, 0.05),
                  "var": (0.5, 2.0)}.get(name, (None, None))
        return a if lo is None else rng.uniform(lo, hi, a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    port = M5(1)
    port.load_state_dict(m5_state_dict(params, stats), strict=True)
    return model, params, stats, port


@pytest.fixture(scope="module")
def m5():
    return seeded()


def jax_offline(m5, wav, cfg=JCFG):
    """sed_tpu's oracle: the hop-strided validation split through its eval
    forward, sigmoid applied."""
    model, params, stats, _ = m5
    frames, _ = frame_coverage_labels(wav[None], [], [], cfg)
    if not len(frames):
        return np.zeros((0, 1), np.float32)
    logits = np.asarray(make_eval_forward(model)(
        params, stats, jnp.asarray(np.transpose(frames, (0, 2, 1)))))
    return 1.0 / (1.0 + np.exp(-logits))


def port_offline(m5, wav, cfg=CFG):
    """The port's offline split: ``cli.infer``'s framing and bucketed scoring."""
    frames = hop_frames(torch.from_numpy(np.asarray(wav, np.float32))[:, None], cfg)
    return score_frames_m5(m5[3].eval(), frames).numpy()


def check(got, m5, wav, tol=SELF_TOL, cfg=(CFG, JCFG), what=""):
    """``got`` within ``tol`` of the port's offline split and within 1e-5
    of sed_tpu's."""
    own, theirs = port_offline(m5, wav, cfg[0]), jax_offline(m5, wav, cfg[1])
    assert got.shape == own.shape == theirs.shape, (what, got.shape, theirs.shape)
    np.testing.assert_allclose(got, own, rtol=0, atol=tol, err_msg=what)
    np.testing.assert_allclose(got, theirs, rtol=0, atol=SED_TPU_TOL, err_msg=what)


def collect(outs, classes=1):
    outs = [o for o in outs if o.shape[0]]
    return np.concatenate(outs) if outs else np.zeros((0, classes), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int16", "mulaw"])
def test_detector_matches_offline_split_and_sed_tpu(m5, dtype):
    """Random push sizes; float32, int16 PCM and uint8 µ-law input."""
    rng = np.random.default_rng(0)
    f32 = (0.1 * rng.standard_normal(6 * FRAME + 1234)).astype(np.float32)
    wire = {"float32": f32, "int16": (f32 * 32768).astype(np.int16),
            "mulaw": mulaw_encode(f32)}[dtype]
    det = ws.WaveformStreamingDetector(m5[3], CFG, device="cpu")
    jdet = jws.WaveformStreamingDetector(*m5[:3], JCFG)
    outs, jouts, pos = [], [], 0
    while pos < len(wire):
        n = int(rng.integers(100, 2 * FRAME))
        outs.append(det.push(wire[pos:pos + n]))
        jouts.append(jdet.push(wire[pos:pos + n]))
        pos += n
    got = collect(outs)
    check(got, m5, ingest_to_f32_np(wire))
    np.testing.assert_allclose(got, collect(jouts), rtol=0, atol=SED_TPU_TOL)


def test_batched_lockstep_streams_equal_single_streams(m5):
    rng = np.random.default_rng(1)
    i16 = (3000 * rng.standard_normal((3, 4 * FRAME))).astype(np.int16)
    det = ws.BatchedWaveformStreamingDetector(m5[3], CFG, batch=3, device="cpu")
    jdet = jws.BatchedWaveformStreamingDetector(*m5[:3], JCFG, batch=3)
    got = np.concatenate([det.push(i16[:, i:i + 5000]) for i in range(0, i16.shape[1], 5000)],
                         axis=1)
    jgot = np.concatenate([jdet.push(i16[:, i:i + 5000])
                           for i in range(0, i16.shape[1], 5000)], axis=1)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=SED_TPU_TOL)
    for b in range(3):
        single = ws.WaveformStreamingDetector(m5[3], CFG, device="cpu").push(i16[b])
        np.testing.assert_allclose(got[b], single, rtol=0, atol=SELF_TOL, err_msg=str(b))
        check(got[b], m5, i16[b].astype(np.float32) / 32768.0, what=str(b))


def test_geometry_fuzz_over_configs():
    """Frame counts and contents equal the offline split for odd frame sizes
    and pushes smaller than a hop, as sed_tpu's fuzz.  The margins keep a
    frame at M5's shortest input, 1,040 samples: below it M5's pools leave
    nothing (torch's max_pool1d raises, as the reference's M5 does)."""
    rng = np.random.default_rng(123)
    for trial in range(4):
        sr = int(rng.choice([4000, 6000, 8000, 11025]))
        margin = float(rng.uniform(max(0.1, 1040 / (2 * sr) + 0.01), 0.5))
        cfg = WaveformConfig(working_sample_rate=sr, time_margin=margin)
        jcfg = JaxWaveformConfig(working_sample_rate=sr, time_margin=margin)
        pair = seeded(jcfg, seed=trial)
        wav = (0.1 * rng.standard_normal(int(rng.integers(cfg.frame_size,
                                                          6 * cfg.frame_size)))
               ).astype(np.float32)
        det = ws.WaveformStreamingDetector(pair[3], cfg, device="cpu")
        outs, pos = [], 0
        while pos < len(wav):
            m = int(rng.integers(1, max(2, cfg.frame_size)))
            outs.append(det.push(wav[pos:pos + m]))
            pos += m
        check(collect(outs), pair, wav, cfg=(cfg, jcfg), what=f"trial {trial} sr={sr}")


def test_host_pool_batched_tick_matches_per_slot(m5):
    """Every slot's frames in shared 8-row blocks: per-slot scores equal
    offline and sed_tpu's pool, in fewer scoring calls than one per slot."""
    pool = ws.WaveformStreamPool(m5[3], CFG, slots=4, frame_bucket=8, device="cpu")
    jpool = jws.WaveformStreamPool(*m5[:3], JCFG, slots=4, frame_bucket=8)
    calls = [0]
    score = pool._score

    def spy(x):
        calls[0] += 1
        return score(x)

    pool._score = spy
    rng = np.random.default_rng(3)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in (5 * FRAME + 123, 3 * FRAME, 4 * FRAME + 7777)]
    got, jgot = {}, {}
    for p, acc in ((pool, got), (jpool, jgot)):
        slots = [p.join() for _ in wavs]
        for s in slots:
            acc[s] = []
        pos = [0] * len(wavs)
        while any(q < len(w) for q, w in zip(pos, wavs)):
            for i, s in enumerate(slots):
                if pos[i] < len(wavs[i]):
                    p.feed(s, wavs[i][pos[i]:pos[i] + 6000 + 1000 * i])
                    pos[i] += 6000 + 1000 * i
            for s, sc in p.tick().items():
                acc[s].append(sc)
        for s in slots:
            acc[s].append(p.leave(s))
    total = 0
    for i, w in enumerate(wavs):
        check(collect(got[i]), m5, w, what=str(i))
        np.testing.assert_allclose(collect(got[i]), collect(jgot[i]), rtol=0, atol=SED_TPU_TOL)
        total += collect(got[i]).shape[0]
    assert calls[0] <= -(-total // 8) + len(wavs) + 2, (calls[0], total)


def test_host_pool_leave_many_matches_per_slot_leave(m5):
    rng = np.random.default_rng(7)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in (3 * FRAME + 500, 2 * FRAME + 4567)]

    def build_and_feed():
        pool = ws.WaveformStreamPool(m5[3], CFG, slots=4, frame_bucket=8, device="cpu")
        slots = [pool.join() for _ in range(3)]   # the third is never fed
        for s, w in zip(slots, wavs):
            pool.feed(s, w[:FRAME])
        pool.tick()
        for s, w in zip(slots, wavs):
            pool.feed(s, w[FRAME:])
        return pool, slots

    pool, slots = build_and_feed()
    ref = [pool.leave(s) for s in slots]
    pool, slots = build_and_feed()
    tails = pool.leave_many(slots + [99])
    for s, r in zip(slots, ref):
        assert tails[s].shape == r.shape
        np.testing.assert_allclose(tails[s], r, rtol=0, atol=SELF_TOL)
    assert isinstance(tails[99], ValueError)
    assert [pool.join() for _ in range(3)] == [0, 1, 2]   # the slots are free


def run_pool(pool, wavs, flood, seed=0):
    """Each stream in turn: fed whole (a multi-round backlog) or in random
    pieces with a tick after each, then left."""
    rng = np.random.default_rng(seed)
    got = {}
    for name, wav in wavs.items():
        s = pool.join()
        acc = []
        if flood:
            pool.feed(s, wav)
            acc.append(pool.tick().get(s, np.zeros((0, 1), np.float32)))
        else:
            pos = 0
            while pos < len(wav):
                n = int(rng.integers(500, 2 * SR))
                pool.feed(s, wav[pos:pos + n])
                pos += n
                acc.append(pool.tick().get(s, np.zeros((0, 1), np.float32)))
        acc.append(pool.leave(s))
        got[name] = collect(acc)
    return got


def test_device_pool_matches_offline_host_pool_and_sed_tpu(m5):
    """Uneven feeds, slot churn, multi-round backlogs and mixed dtypes: the
    device pool equals the offline split, the host pool and sed_tpu's device
    pool on the same audio."""
    rng = np.random.default_rng(17)
    wavs = {
        "a": (0.1 * rng.standard_normal(5 * FRAME + 4321)).astype(np.float32),
        "b": (3000 * rng.standard_normal(9 * FRAME + 999)).astype(np.int16),
        "c": mulaw_encode((0.1 * rng.standard_normal(2 * FRAME + 77)).astype(np.float32)),
    }
    runs = {
        "flood": run_pool(ws.DeviceWaveformStreamPool(m5[3], CFG, slots=2, chunk_samples=SR,
                                                      device="cpu"), wavs, True),
        "paced": run_pool(ws.DeviceWaveformStreamPool(m5[3], CFG, slots=2, chunk_samples=SR,
                                                      device="cpu"), wavs, False),
        "host": run_pool(ws.WaveformStreamPool(m5[3], CFG, slots=2, device="cpu"), wavs,
                         False),
        "sed_tpu": run_pool(jws.DeviceWaveformStreamPool(*m5[:3], JCFG, slots=2,
                                                         chunk_samples=SR), wavs, True),
    }
    for name, wav in wavs.items():
        f32 = ingest_to_f32_np(wav)
        for label in ("flood", "paced", "host"):
            check(runs[label][name], m5, f32, tol=DEVICE_TOL, what=f"{name}/{label}")
        np.testing.assert_allclose(runs["flood"][name], runs["host"][name], rtol=0,
                                   atol=SELF_TOL)
        np.testing.assert_allclose(runs["flood"][name], runs["sed_tpu"][name], rtol=0,
                                   atol=SED_TPU_TOL)


def test_device_pool_sparse_slots_and_leave_many(m5):
    """Slots at different rates keep the idle rows untouched; leave_many
    drains both and equals per-slot leave; the slots are free after."""
    rng = np.random.default_rng(23)
    wav_a = (0.1 * rng.standard_normal(4 * FRAME + 100)).astype(np.float32)
    wav_b = (0.1 * rng.standard_normal(6 * FRAME + 3000)).astype(np.float32)

    def run(many):
        pool = ws.DeviceWaveformStreamPool(m5[3], CFG, slots=3, chunk_samples=SR,
                                           device="cpu")
        a, b = pool.join(), pool.join()
        acc = {a: [], b: []}
        pa = pb = 0
        while pa < len(wav_a) or pb < len(wav_b):
            if pa < len(wav_a):
                pool.feed(a, wav_a[pa:pa + SR // 2])
                pa += SR // 2
            if pb < len(wav_b):
                pool.feed(b, wav_b[pb:pb + 2 * SR])
                pb += 2 * SR
            for s, sc in pool.tick().items():
                acc[s].append(sc)
        tails = pool.leave_many([a, b, 7]) if many else {a: pool.leave(a), b: pool.leave(b)}
        if many:
            assert isinstance(tails[7], ValueError)
        for s in (a, b):
            acc[s].append(tails[s])
        assert pool.join() in (a, b)
        return collect(acc[a]), collect(acc[b])

    got_a, got_b = run(True)
    check(got_a, m5, wav_a, tol=DEVICE_TOL)
    check(got_b, m5, wav_b, tol=DEVICE_TOL)
    one_a, one_b = run(False)
    np.testing.assert_allclose(got_a, one_a, rtol=0, atol=SELF_TOL)
    np.testing.assert_allclose(got_b, one_b, rtol=0, atol=SELF_TOL)


def test_device_pool_backlog_beyond_one_block(m5):
    """A backlog of more than ROUNDS_PER_CALL chunks goes in blocks of at
    most that many rounds, each one upload of only the real chunks."""
    pool = ws.DeviceWaveformStreamPool(m5[3], CFG, slots=3, chunk_samples=SR, device="cpu")
    blocks = []
    push_rounds = pool._push_rounds

    def spy(rounds):
        blocks.append([sorted(r) for r in rounds])
        return push_rounds(rounds)

    pool._push_rounds = spy
    rng = np.random.default_rng(5)
    n_chunks = pool.ROUNDS_PER_CALL + 5
    long = (3000 * rng.standard_normal(n_chunks * SR + 321)).astype(np.int16)
    short = (3000 * rng.standard_normal(3 * SR)).astype(np.int16)
    a, b = pool.join(), pool.join()
    pool.feed(a, long)
    pool.feed(b, short)
    out = pool.tick()
    assert [len(r) for r in blocks] == [pool.ROUNDS_PER_CALL, 5]
    assert blocks[0][:3] == [[a, b]] * 3 and blocks[0][3:] == [[a]] * 13
    got = collect([out[a], pool.leave(a)])
    check(got, m5, long.astype(np.float32) / 32768.0, tol=DEVICE_TOL)
    check(collect([out[b], pool.leave(b)]), m5, short.astype(np.float32) / 32768.0,
          tol=DEVICE_TOL)


def test_pools_launch_no_kernel_refuse_unported_and_need_a_card(m5):
    kernels.reset_launch_counts()
    pool = ws.DeviceWaveformStreamPool(m5[3], CFG, slots=1, chunk_samples=SR, device="cpu")
    s = pool.join()
    pool.feed(s, np.zeros(3 * SR, np.int16))
    pool.tick()
    pool.leave(s)
    assert sum(kernels.LAUNCHES.values()) == 0
    # Once refused: mesh (tests/test_torch_parallel.py); slots that do not
    # divide over it raise sed_tpu's error.
    from sed_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="slots 3 must divide over the 2-device mesh"):
        ws.DeviceWaveformStreamPool(m5[3], CFG, slots=3,
                                    mesh=Mesh(None, 2, 0, torch.device("cpu")), device="cpu")
    # Once refused: qparams (int8) in both pools, each equal to offline int8
    # scoring of the frames.
    from sed_tpu_torch.models.quantize import quantize_m5, quantized_m5_forward

    wav = (0.1 * np.random.default_rng(21).standard_normal(2 * SR + FRAME)).astype(np.float32)
    frames = hop_frames(torch.from_numpy(wav)[:, None], CFG)
    qp = quantize_m5(m5[3], [frames])
    want = torch.sigmoid(quantized_m5_forward(qp, frames)).numpy()
    for cls, kw in ((ws.DeviceWaveformStreamPool, dict(chunk_samples=SR)),
                    (ws.WaveformStreamPool, {})):
        p8 = cls(m5[3], CFG, slots=1, qparams=qp, device="cpu", **kw)
        s8 = p8.join()
        p8.feed(s8, wav)
        got = collect([p8.tick().get(s8, np.zeros((0, 1), np.float32)), p8.leave(s8)])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="chunk_samples"):
        ws.DeviceWaveformStreamPool(m5[3], CFG, chunk_samples=FRAME - 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ws.DeviceWaveformStreamPool(m5[3], CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ws.WaveformStreamingDetector(m5[3], CFG)


def test_scoring_puts_the_model_in_eval_mode(m5):
    """After ``model.train()`` the pools score as in eval mode and leave
    the running statistics alone."""
    model = m5[3]
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    wav = (0.1 * np.random.default_rng(9).standard_normal(3 * FRAME)).astype(np.float32)
    model.train()
    det = ws.WaveformStreamingDetector(model, CFG, device="cpu")
    got = det.push(wav)
    assert not model.training
    check(got, m5, wav)
    for k, v in model.state_dict().items():
        assert torch.equal(v, stats[k]), k

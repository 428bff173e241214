"""sed_tpu_torch's StreamPool against sed_tpu, on the CPU (following
tests/test_stream_pool.py).

Every stream of a port pool, through joins, leaves, sparse pushes and uneven
feeds, must emit the blocks a fresh ``sed_tpu`` single-stream detector emits
on the same audio: identical emission counts, scores within 1e-5, on weights
carried across with ``models/convert.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.stream_pool import StreamPool as JaxStreamPool
from sed_tpu.streaming import BatchedStreamingDetector as JaxDetector
from sed_tpu.streaming import make_stream_fns
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.mulaw import mulaw_decode_np, mulaw_encode
from sed_tpu_torch.stream_pool import StreamPool

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


def pool(models, slots, **kw):
    return StreamPool(models[3], CFG, slots=slots, device="cpu", **KW, **kw)


def fresh_run(models, chunks):
    """Oracle: a fresh sed_tpu single-stream detector over the same chunks.
    Returns (per-push blocks, flush tail)."""
    flax_model, params, stats, _, fns = models
    det = JaxDetector(flax_model, params, stats, JCFG, batch=1, halo=64,
                      total_stride=8, bucket=64, stream_fns=fns)
    outs = [det.push(np.asarray(c, np.float32)[None])[0] for c in chunks]
    return outs, det.flush()[0]


def joined(blocks):
    blocks = [b for b in blocks if b.shape[0]]
    return np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 1), np.float32)


def assert_stream_matches(models, got, tail, chunks, name):
    """Per-push block shapes equal, and all scores within ATOL."""
    ref_outs, ref_tail = fresh_run(models, chunks)
    assert len(got) == len(ref_outs), name
    for i, (g, r) in enumerate(zip(got, ref_outs)):
        assert g.shape == r.shape, (name, i, g.shape, r.shape)
    g_all, r_all = joined(got + [tail]), joined(ref_outs + [ref_tail])
    assert g_all.shape == r_all.shape, name
    np.testing.assert_allclose(g_all, r_all, rtol=0, atol=ATOL, err_msg=name)


def test_pool_join_leave_matches_fresh_streams(models):
    """Three overlapping lives on a 2-slot pool: A [tick 0..14], B [3..20]
    (another schedule phase), C [16..24] reusing A's freed slot."""
    rng = np.random.default_rng(0)
    lives = {"A": (0, 15), "B": (3, 18), "C": (16, 9)}
    audio = {k: (0.1 * rng.standard_normal((n, CHUNK))).astype(np.float32)
             for k, (_, n) in lives.items()}
    p = pool(models, 2)
    slot_of, fed = {}, {k: 0 for k in lives}
    got, tails = {k: [] for k in lives}, {}
    for tick in range(30):
        for k, (j, _) in lives.items():
            if tick == j:
                slot_of[k] = p.join()
        live = {k for k, (j, n) in lives.items() if j <= tick < j + n}
        out = p.push({slot_of[k]: audio[k][fed[k]] for k in live})
        for k in live:
            got[k].append(out[slot_of[k]])
            fed[k] += 1
        for k, (j, n) in lives.items():
            if tick == j + n - 1:
                tails[k] = p.leave(slot_of.pop(k))
    for k in lives:
        assert_stream_matches(models, got[k], tails[k], audio[k], k)


def test_pool_sparse_ticks_match_fresh_streams(models):
    """Streams at different rates: A every tick, B every 2nd, C (joining
    late) every 3rd.  Idle ticks leave a slot's rings untouched."""
    rng = np.random.default_rng(7)
    lives = {"A": (0, 1, 12), "B": (1, 2, 8), "C": (8, 3, 5)}
    audio = {k: (0.1 * rng.standard_normal((n, CHUNK))).astype(np.float32)
             for k, (_, _, n) in lives.items()}
    p = pool(models, 3)
    slot_of, fed = {}, {k: 0 for k in lives}
    got, tails = {k: [] for k in lives}, {}
    for tick in range(40):
        for k, (j, _, _) in lives.items():
            if tick == j:
                slot_of[k] = p.join()
        pushing = [k for k, (j, period, n) in lives.items()
                   if k in slot_of and tick >= j and (tick - j) % period == 0
                   and fed[k] < n]
        out = p.push({slot_of[k]: audio[k][fed[k]] for k in pushing})
        assert set(out) == {slot_of[k] for k in pushing}
        for k in pushing:
            got[k].append(out[slot_of[k]])
            fed[k] += 1
            if fed[k] == lives[k][2]:
                tails[k] = p.leave(slot_of.pop(k))
    for k in lives:
        assert_stream_matches(models, got[k], tails[k], audio[k], k)


def test_pool_feed_tick_uneven_pieces_match_fresh_streams(models):
    """feed()/tick() with random piece sizes (0.1x-1.8x the chunk), ticks at
    an irregular cadence, multi-round blocks, and a partial remainder drained
    by leave(), for float32, int16 and mixed-dtype feeds."""
    rng = np.random.default_rng(11)
    total = {"f32": 9 * CHUNK + 1234, "i16": 7 * CHUNK + 777, "mix": 6 * CHUNK + 3210}
    audio = {k: (0.1 * rng.standard_normal(n)).astype(np.float32)
             for k, n in total.items()}
    audio["i16"] = (audio["i16"] * 32768.0).astype(np.int16)
    audio["mix"] = (np.round(audio["mix"] * 32768.0).astype(np.int16)
                    .astype(np.float32) / 32768.0)
    p = pool(models, 3)
    p.profile = {}
    slot_of = {k: p.join() for k in audio}
    pos, got, step = {k: 0 for k in audio}, {k: [] for k in audio}, 0
    while any(pos[k] < len(audio[k]) for k in audio):
        for k in audio:
            n = int(rng.integers(CHUNK // 10, 2 * CHUNK))
            piece = audio[k][pos[k]: pos[k] + n]
            pos[k] += len(piece)
            if k == "mix" and step % 2:
                piece = (piece * 32768.0).astype(np.int16)
            p.feed(slot_of[k], piece)
        step += 1
        if step % 3 == 0:
            for b, sc in p.tick().items():
                got[next(k for k in audio if slot_of[k] == b)].append(sc)
    for b, sc in p.tick().items():
        got[next(k for k in audio if slot_of[k] == b)].append(sc)
    tails = {k: p.leave(slot_of[k]) for k in audio}
    assert p.profile["blocks"] > 0 and p.profile["pending_rounds"] > 0
    assert p.profile["rounds_real"] > p.profile["blocks"]    # multi-round blocks

    for k in audio:
        ref = audio[k].astype(np.float32) / 32768.0 if audio[k].dtype == np.int16 \
            else audio[k]
        ref_outs, ref_tail = fresh_run(models, [ref])
        g_all, r_all = joined(got[k] + [tails[k]]), joined(ref_outs + [ref_tail])
        assert g_all.shape == r_all.shape, k
        np.testing.assert_allclose(g_all, r_all, rtol=0, atol=ATOL, err_msg=k)


def test_multi_round_tick_matches_per_round_push(models):
    """Staging 21 and 13 chunks and ticking once rides 16-round blocks;
    scores equal per-round push() and the tails drain alike."""
    rng = np.random.default_rng(41)
    n = {"A": 21, "B": 13}
    audio = {k: (0.1 * rng.standard_normal((m, CHUNK))).astype(np.float32)
             for k, m in n.items()}
    ref_pool, p = pool(models, 3), pool(models, 3)
    ref_slots = {k: ref_pool.join() for k in n}
    ref = {k: [] for k in n}
    for t in range(max(n.values())):
        o = ref_pool.push({ref_slots[k]: audio[k][t] for k in n if t < n[k]})
        for k in n:
            if t < n[k]:
                ref[k].append(o[ref_slots[k]])
    slots = {k: p.join() for k in n}
    calls = []
    orig = p._push_rounds

    def spy(rounds):
        calls.append(len(rounds))
        return orig(rounds)

    p._push_rounds = spy
    for k in n:
        p.feed(slots[k], audio[k].reshape(-1))
    got = p.tick()
    assert max(calls) == StreamPool.ROUNDS_PER_CALL and len(calls) == 2, calls
    for k in n:
        want = joined(ref[k])
        assert got[slots[k]].shape == want.shape, k
        np.testing.assert_allclose(got[slots[k]], want, rtol=0, atol=ATOL, err_msg=k)
        tail, tail_ref = p.leave(slots[k]), ref_pool.leave(ref_slots[k])
        assert tail.shape == tail_ref.shape
        np.testing.assert_allclose(tail, tail_ref, rtol=0, atol=ATOL, err_msg=k)


def test_leave_many_matches_per_slot_leave(models):
    """leave_many (one shared featurize, one stacked forward per window
    length) equals per-slot leave() across drain states: admitted with a
    staged remainder, other tail lengths, pending-only, never fed, and too
    short to featurize."""
    rng = np.random.default_rng(31)
    n_chunks = {"A": 5, "B": 3, "C": 1}
    audio = {k: (0.1 * rng.standard_normal((n, CHUNK))).astype(np.float32)
             for k, n in n_chunks.items()}
    rem = (0.1 * rng.standard_normal(1234)).astype(np.float32)
    tiny = (0.1 * rng.standard_normal(100)).astype(np.float32)

    def run(p):
        slots = {k: p.join() for k in "ABCDE"}
        for t in range(5):
            p.push({slots[k]: audio[k][t] for k in n_chunks if t < n_chunks[k]})
        p.feed(slots["A"], rem)
        p.feed(slots["E"], tiny)
        return slots

    pool_ref, pool_many = pool(models, 5), pool(models, 5)
    slots_ref, slots_many = run(pool_ref), run(pool_many)
    ref = {k: pool_ref.leave(slots_ref[k]) for k in "ABCD"}
    with pytest.raises(ValueError, match="too short"):
        pool_ref.leave(slots_ref["E"])

    calls = []
    feat, fwd = pool_many._stream_fns

    def feat_spy(x):
        calls.append(("featurize", tuple(x.shape)))
        return feat(x)

    def fwd_spy(x):
        calls.append(("forward", tuple(x.shape)))
        return fwd(x)

    pool_many._stream_fns = (feat_spy, fwd_spy)
    tails = pool_many.leave_many([slots_many[k] for k in "ABCDE"])
    for k in "ABCD":
        got = tails[slots_many[k]]
        assert got.shape == ref[k].shape, k
        np.testing.assert_allclose(got, ref[k], rtol=0, atol=ATOL, err_msg=k)
    assert tails[slots_many["E"]].shape == (0, 1)
    assert [c for c, _ in calls].count("featurize") == 1, calls
    lengths = [s[2] for c, s in calls if c == "forward"]
    assert len(lengths) == len(set(lengths)), calls
    # A's staged remainder and the host flush: equal to sed_tpu too.
    ref_outs, ref_tail = fresh_run(models, list(audio["A"]) + [rem])
    np.testing.assert_allclose(joined([tails[slots_many["A"]]]),
                               joined(ref_outs[5:] + [ref_tail]), rtol=0, atol=ATOL)
    for _ in range(5):
        pool_many.join()   # every slot was freed


def test_pool_extract_span_equals_slices(models):
    rng = np.random.default_rng(11)
    n = 14
    audio = (0.1 * rng.standard_normal((2, n, CHUNK))).astype(np.float32)

    def run(extract_impl):
        p = pool(models, 2, extract_impl=extract_impl)
        a = p.join()
        outs = {a: [p.push({a: audio[0, 0]})[a]]}   # stagger the slot phases
        b = p.join()
        outs[b] = []
        for i in range(1, n):
            o = p.push({a: audio[0, i], b: audio[1, i - 1]})
            outs[a].append(o[a])
            outs[b].append(o[b])
        outs[a].append(p.leave(a))
        outs[b].append(p.leave(b))
        return {k: joined(v) for k, v in outs.items()}

    span, slices = run("span"), run("slices")
    for k in span:
        assert span[k].shape == slices[k].shape
        np.testing.assert_allclose(span[k], slices[k], rtol=0, atol=ATOL)


def test_pool_int16_and_mulaw_chunks_match_host_decode(models):
    """int16 and uint8 µ-law chunks ride the upload as they are and are
    decoded in the tick; scores equal feeding the host-decoded float32.  A
    mixed uint8 + int16 push goes up as host-decoded float32."""
    rng = np.random.default_rng(5)
    n = 8
    u8 = mulaw_encode((0.1 * rng.standard_normal((n, CHUNK))).astype(np.float32))
    i16 = (0.05 * rng.standard_normal((n, CHUNK)) * 32768.0).astype(np.int16)

    def run_single(chunks):
        p = pool(models, 1)
        s = p.join()
        return joined([p.push({s: c})[s] for c in chunks] + [p.leave(s)])

    dec_u8, dec_i16 = mulaw_decode_np(u8), i16.astype(np.float32) / 32768.0
    np.testing.assert_allclose(run_single(list(u8)), run_single(list(dec_u8)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(run_single(list(i16)), run_single(list(dec_i16)),
                               rtol=0, atol=ATOL)
    p = pool(models, 2)
    a, b = p.join(), p.join()
    outs_a, outs_b = [], []
    for t in range(n):
        o = p.push({a: u8[t], b: i16[t]})
        outs_a.append(o[a])
        outs_b.append(o[b])
    ref_outs, ref_tail = fresh_run(models, dec_u8)
    np.testing.assert_allclose(joined(outs_a + [p.leave(a)]),
                               joined(ref_outs + [ref_tail]), rtol=0, atol=ATOL)
    ref_outs, ref_tail = fresh_run(models, dec_i16)
    np.testing.assert_allclose(joined(outs_b + [p.leave(b)]),
                               joined(ref_outs + [ref_tail]), rtol=0, atol=ATOL)


def test_pool_matches_sed_tpu_pool_block_for_block(models):
    """The port's pool and sed_tpu's pool, fed the same feed/tick sequence,
    return the same slots and block shapes from every tick."""
    flax_model, params, stats, _, _ = models
    rng = np.random.default_rng(17)
    audio = [(3000 * rng.standard_normal(n)).astype(np.int16)
             for n in (11 * CHUNK + 5, 4 * CHUNK + 4321)]
    ours = pool(models, 2)
    theirs = JaxStreamPool(flax_model, params, stats, JCFG, slots=2, **KW)
    slots = [(ours.join(), theirs.join()) for _ in audio]
    for start, stop in [(0, 3000), (3000, 40000), (40000, 90000), (90000, None)]:
        for (a, b), y in zip(slots, audio):
            if y[start:stop].size:
                ours.feed(a, y[start:stop])
                theirs.feed(b, y[start:stop])
        got, want = ours.tick(), theirs.tick()
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL)
    for a, b in slots:
        tail, tail_ref = ours.leave(a), theirs.leave(b)
        assert tail.shape == tail_ref.shape
        np.testing.assert_allclose(tail, tail_ref, rtol=0, atol=ATOL)


def test_tick_fault_keeps_scores_of_blocks_already_scored(models):
    """Fault R2: when a later block raises, tick() raised and the scores of
    the blocks already scored were lost with their consumed samples.  The
    port returns them from the next tick (or from leave)."""
    rng = np.random.default_rng(23)
    audio = (0.1 * rng.standard_normal((40, CHUNK))).astype(np.float32)
    ref_outs, ref_tail = fresh_run(models, audio)

    for deliver in ("tick", "leave"):
        p = pool(models, 1)
        s = p.join()
        head = [p.push({s: c})[s] for c in audio[:3]]   # admitted after startup
        assert s in p._admitted
        calls = [0]
        orig = p._push_rounds

        def flaky(rounds):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("device fault (simulated)")
            return orig(rounds)

        p._push_rounds = flaky
        p.feed(s, audio[3:].reshape(-1))            # 37 rounds: blocks 16+16+5
        with pytest.raises(RuntimeError, match="simulated"):
            p.tick()
        assert p.staged(s) == 21 * CHUNK            # blocks 2 and 3 restaged
        if deliver == "tick":
            rest = [p.tick()[s]]
            assert calls[0] == 4
            tail = p.leave(s)
        else:
            rest = []
            tail = p.leave(s)                       # block 1's scores + flush
        g_all = joined(head + rest + [tail])
        r_all = joined(ref_outs + [ref_tail])
        assert g_all.shape == r_all.shape, deliver
        np.testing.assert_allclose(g_all, r_all, rtol=0, atol=ATOL, err_msg=deliver)


def test_pool_validation(models):
    p = pool(models, 1)
    s = p.join()
    with pytest.raises(RuntimeError, match="slots are occupied"):
        p.join()
    assert p.push({}) == {}
    with pytest.raises(ValueError, match="non-joined"):
        p.push({s: np.zeros(CHUNK, np.float32), s + 1: np.zeros(CHUNK, np.float32)})
    with pytest.raises(ValueError, match="chunk must be"):
        p.push({s: np.zeros(17, np.float32)})
    with pytest.raises(ValueError, match="not joined"):
        p.leave(s + 1)
    with pytest.raises(ValueError, match="not joined"):
        p.feed(s + 1, np.zeros(10, np.int16))
    with pytest.raises(ValueError, match="1-D"):
        p.feed(s, np.zeros((2, 10), np.int16))
    assert p.leave(s).shape == (0, 1)    # never fed: nothing to flush
    assert p.join() == s                 # a freed slot is reused


def test_pool_push_is_atomic_on_invalid_chunk(models):
    rng = np.random.default_rng(3)
    chunk = (0.1 * rng.standard_normal(CHUNK)).astype(np.float32)
    p = pool(models, 2)
    a, b = p.join(), p.join()
    with pytest.raises(ValueError, match="chunk must be"):
        p.push({a: chunk, b: np.zeros(17, np.float32)})
    h = p._pending[a]
    assert h._buf_start + h._samples.shape[1] == 0
    retry = p.push({a: chunk, b: chunk})
    q = pool(models, 2)
    qa, qb = q.join(), q.join()
    ref = q.push({qa: chunk, qb: chunk})
    np.testing.assert_array_equal(retry[a], ref[qa])
    np.testing.assert_array_equal(retry[b], ref[qb])


def test_pool_lifecycle_shares_one_stream_fns_pair(models):
    rng = np.random.default_rng(7)
    p = pool(models, 2)
    feat, fwd = p._stream_fns
    a = p.join()
    assert p._pending[a]._featurize is feat and p._pending[a]._forward is fwd
    for c in (0.1 * rng.standard_normal((6, CHUNK))).astype(np.float32):
        p.push({a: c})
    assert a in p._admitted
    h, _ = p._checkout(a)
    assert h._featurize is feat and h._forward is fwd


def test_pool_cpu_run_launches_no_kernel_and_refuses_unported(models):
    kernels.reset_launch_counts()
    p = pool(models, 1)
    s = p.join()
    for c in np.zeros((4, CHUNK), np.int16):
        p.push({s: c})
    p.leave(s)
    assert sum(kernels.LAUNCHES.values()) == 0
    port = models[3]
    with pytest.raises(ValueError, match="auto|xla|pallas"):
        StreamPool(port, CFG, featurizer="bogus", device="cpu")
    # Once refused: mesh (tests/test_torch_parallel.py); slots that do not
    # divide over it raise sed_tpu's error.
    from sed_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="slots 3 must divide over the 2-device mesh"):
        StreamPool(port, CFG, slots=3, mesh=Mesh(None, 2, 0, torch.device("cpu")),
                   device="cpu")
    # Once refused: an int8 pool slot equals a fresh int8 detector.
    from sed_tpu_torch.models.quantize import quantize_cnn
    from sed_tpu_torch.streaming import BatchedStreamingDetector

    audio = (0.1 * np.random.default_rng(12).standard_normal((6, CHUNK))).astype(np.float32)
    qp = quantize_cnn(port, [np.random.default_rng(13).standard_normal(
        (1, 1, 64, CFG.mel_bins)).astype(np.float32)])
    p8 = StreamPool(port, CFG, slots=2, qparams=qp, device="cpu", **KW)
    s8 = p8.join()
    got = joined([p8.push({s8: c})[s8] for c in audio] + [p8.leave(s8)])
    det = BatchedStreamingDetector(port, CFG, batch=1, halo=64, total_stride=8, bucket=64,
                                   qparams=qp, device="cpu")
    want = joined([det.push(c[None])[0] for c in audio] + [det.flush()[0]])
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # The fast tier, once refused here, builds (K3t); a tier sed_tpu does not
    # name is refused with its message.
    assert StreamPool(port, CFG, featurizer_precision="fast", device="cpu").slots == 8
    with pytest.raises(ValueError, match="unknown featurizer precision tier"):
        StreamPool(port, CFG, featurizer_precision="faster", device="cpu")
    with pytest.raises(ValueError, match="extract_impl"):
        StreamPool(port, CFG, extract_impl="bogus", device="cpu")


def test_pool_xla_featurizer_matches_fresh_streams(models):
    """featurizer='xla' (the windowed rFFT and the mel projection in PyTorch
    ops, ``ops.featurizer.logmel_frames_xla``) for the startup, the ring
    tick and the drain: the blocks of a fresh sed_tpu detector."""
    rng = np.random.default_rng(11)
    audio = (0.1 * rng.standard_normal((10, CHUNK))).astype(np.float32)
    p = pool(models, 2, featurizer="xla")
    s = p.join()
    got = [p.push({s: c})[s] for c in audio]
    assert s in p._admitted
    assert_stream_matches(models, got, p.leave(s), audio, "xla")

"""The port's M5 (waveform) training against sed_tpu's, on the CPU.

The corpus is tests/test_data.py's: six 15 s WAVs at 8 kHz (WaveformConfig
at 8 kHz: frame 5280, hop 2640), one 1 s 800 Hz event each.  Weights come
from one flax init of sed_tpu's M5 (the direct stem, ``conv1_s2d=False``,
which is the stem the port runs), carried over by
``models.convert.m5_state_dict``.

Tolerances: WaveformDataset's buffers, labels, start indices, epoch batches
and validation frames equal; the augmentation apply on sed_tpu's own draws
within 1e-6 of sed_tpu's augmented crops, labels equal; one train step's
loss within 1e-5 relative, its first gradients within 1e-4 of each tensor's
largest |grad|, the parameters (where the gradient is clear of zero: see
test_one_step_matches_sed_tpu) and BatchNorm statistics after it within
1e-4 of each tensor's largest value; evaluate()'s logits within 1e-5, its
losses within 1e-5 relative and its metrics equal; train()'s per-step
losses within 1e-5 relative of sed_tpu's loop without augmentation, at lr
1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data import device_pipeline as jax_pipe
from sed_tpu.data.waveform_dataset import WaveformDataset as JaxWaveformDataset
from sed_tpu.io.labels import LabeledAudio as JaxLabeledAudio
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.train import loop as jax_loop
from sed_tpu.train.optim import make_optimizer as jax_make_optimizer
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.cli import infer as cli_infer
from sed_tpu_torch.cli import main as cli_main
from sed_tpu_torch.configs import DEFAULT_WAVEFORM, WaveformConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.data.waveform_dataset import WaveformDataset
from sed_tpu_torch.io.labels import LabeledAudio
from sed_tpu_torch.models.convert import m5_state_dict
from sed_tpu_torch.models.layers import BatchNorm1d
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.train import loop
from sed_tpu_torch.train.state import init_state

WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
JWCFG = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_data.py's corpus: (path, starts, ends, name) items."""
    root = tmp_path_factory.mktemp("wave_corpus")
    rng = np.random.default_rng(0)
    items = []
    sr = WCFG.working_sample_rate
    for i in range(6):
        sig = 0.01 * rng.standard_normal(15 * sr)
        start = 4.0 + i * 0.5
        t = np.arange(sr) / sr
        sig[int(start * sr):int(start * sr) + sr] += 0.5 * np.sin(2 * np.pi * 800 * t)
        path = str(root / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        items.append((path, np.array([start]), np.array([start + 1.0]), f"clip_{i}"))
    return items


def datasets(items, val="clip_5", seed=0, **kw):
    a = WaveformDataset(items, val_descriptor=val, cfg=WCFG, seed=seed, **kw)
    b = JaxWaveformDataset(items, val_descriptor=val, cfg=JWCFG, seed=seed, **kw)
    return a, b


def flax_m5(batch, seed=0, lr=1e-3):
    """sed_tpu's M5 state as its train() builds it, and the port's M5
    holding the same weights."""
    model = FlaxM5(classes_num=1, conv1_s2d=False)
    sample = jnp.zeros((batch, WCFG.frame_size, 1), jnp.float32)
    jstate = jax_init_state(model, jax.random.key(seed), sample, jax_make_optimizer(lr))
    port = M5(1)
    port.load_state_dict(m5_state_dict(np_tree(jstate.params), np_tree(jstate.batch_stats)))
    return model, jstate, port


# ---------------------------------------------------------------------------
# WaveformDataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("balance", [False, True], ids=["all", "balanced"])
@pytest.mark.parametrize("val", [0.34, "clip_5"])
def test_waveform_dataset_matches_sed_tpu(corpus, val, balance):
    a, b = datasets(corpus, val=val, balance_classes=balance)
    np.testing.assert_array_equal(a.long_waveform, b.long_waveform)
    np.testing.assert_array_equal(a.all_start_indices_labels, b.all_start_indices_labels)
    np.testing.assert_array_equal(a.possible_start_indices, b.possible_start_indices)
    assert a.possible_start_indices.dtype == np.int32 and len(a) == len(b) > 0
    for x, y in zip(a.epoch_start_indices(8), b.epoch_start_indices(8)):
        np.testing.assert_array_equal(x, y)
    assert len(list(a.epoch_start_indices(8, drop_last=False))) == -(-len(a) // 8)
    for idx in (0, 7, len(a) - 1):
        for x, y in zip(a.get_item(idx), b.get_item(idx)):
            np.testing.assert_array_equal(x, y)
    got, want = list(a.get_validation_sampler()), list(b.get_validation_sampler())
    assert len(got) == len(want) > 0
    for (f, l, n), (jf, jl, jn) in zip(got, want):
        assert n == jn and f.shape[1:] == (1, WCFG.frame_size)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(l, jl)
        assert l.dtype == np.float32


def test_waveform_dataset_labels_and_validation_limit(corpus):
    a, _ = datasets(corpus)
    n_per_file = 15 * WCFG.working_sample_rate - WCFG.frame_size
    assert len(a) == 5 * n_per_file
    assert a.all_start_indices_labels.sum() > 0
    assert len(list(a.get_validation_sampler(0))) == 0
    a, _ = datasets(corpus, val=0.5)
    assert len(list(a.get_validation_sampler(2))) == 2   # the exact limit
    assert len(list(a.get_validation_sampler())) == 3


def test_waveform_dataset_multiclass_matches_sed_tpu(corpus):
    cfg = WaveformConfig(working_sample_rate=8000, time_margin=0.33,
                         tau_sed_labels=("doorslam", "speech"))
    jcfg = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33,
                             tau_sed_labels=("doorslam", "speech"))
    with pytest.raises(ValueError, match="class"):
        WaveformDataset(corpus, val_descriptor="clip_5", cfg=cfg, seed=0)
    ours = [LabeledAudio(p, s, e, n, np.array([i % 2])) for i, (p, s, e, n) in
            enumerate(corpus)]
    theirs = [JaxLabeledAudio(p, s, e, n, np.array([i % 2])) for i, (p, s, e, n) in
              enumerate(corpus)]
    a = WaveformDataset(ours, val_descriptor="clip_5", cfg=cfg, seed=0)
    b = JaxWaveformDataset(theirs, val_descriptor="clip_5", cfg=jcfg, seed=0)
    assert a.all_start_indices_labels.shape == (a.long_waveform.shape[1], 2)
    np.testing.assert_array_equal(a.all_start_indices_labels, b.all_start_indices_labels)
    np.testing.assert_array_equal(a.possible_start_indices, b.possible_start_indices)
    (f, l, _), = a.get_validation_sampler()
    (jf, jl, _), = b.get_validation_sampler()
    np.testing.assert_array_equal(l, jl)
    assert l.shape == (len(f), 2)


def test_waveform_dataset_refuses_workers(corpus):
    """``workers > 0``, once refused, loads the files on the native reader's
    threads: at the working rate the dataset equals ``workers=0``'s."""
    a = WaveformDataset(corpus, cfg=WCFG, seed=0)
    b = WaveformDataset(corpus, cfg=WCFG, seed=0, workers=2)
    np.testing.assert_array_equal(a.long_waveform, b.long_waveform)
    np.testing.assert_array_equal(a.all_start_indices_labels, b.all_start_indices_labels)
    np.testing.assert_array_equal(a.possible_start_indices, b.possible_start_indices)
    for (f, l, _), (g, m, _) in zip(a.get_validation_sampler(), b.get_validation_sampler()):
        np.testing.assert_array_equal(f, g)
        np.testing.assert_array_equal(l, m)


# ---------------------------------------------------------------------------
# Buffers, gather, augmentation
# ---------------------------------------------------------------------------

def test_waveform_buffers_from_dataset(corpus):
    a, b = datasets(corpus)
    bufs = pipe.waveform_buffers_from_dataset(a, "cpu")
    jbufs = jax_pipe.waveform_buffers_from_dataset(b)
    assert bufs.waveform.dtype == bufs.labels.dtype == torch.float32
    assert bufs.start_indices.dtype == torch.int64
    np.testing.assert_array_equal(bufs.waveform.numpy(), np.asarray(jbufs.waveform))
    np.testing.assert_array_equal(bufs.labels.numpy(), np.asarray(jbufs.labels))
    np.testing.assert_array_equal(bufs.start_indices.numpy(), np.asarray(jbufs.start_indices))


def test_gather_equals_the_host_crops(corpus):
    a, _ = datasets(corpus)
    bufs = pipe.waveform_buffers_from_dataset(a, "cpu")
    starts = torch.from_numpy(a.possible_start_indices[:16])
    waves, labels = pipe.make_waveform_gather(WCFG)(bufs, starts)
    assert waves.shape == (16, 1, WCFG.frame_size) and labels.shape == (16,)
    for i in range(16):
        w, lab = a.get_item(i)
        np.testing.assert_array_equal(waves[i].numpy(), w)
        assert labels[i].item() == float(lab)
    # The last legal start reaches the buffer's end.
    last = torch.tensor([a.long_waveform.shape[1] - WCFG.frame_size])
    w, _ = pipe.make_waveform_gather(WCFG)(bufs, last)
    np.testing.assert_array_equal(w[0].numpy(), a.long_waveform[:, -WCFG.frame_size:])


class _Recorder:
    """sed_tpu's model, recording the (augmented) input of each apply."""

    def __init__(self, model):
        self.model, self.x = model, None

    def apply(self, variables, x, **kw):
        self.x = np.asarray(x)
        return self.model.apply(variables, x, **kw)


def sed_tpu_augmented(monkeypatch, jbufs, starts, rng, batch):
    """The crops and labels sed_tpu's make_waveform_train_step trains on with
    augmentation, read from its unjitted step."""
    seen = {}
    real_loss = jax_pipe.weighted_bce_with_logits

    def loss(out, labels, *args, **kw):
        seen["labels"] = np.asarray(labels)
        return real_loss(out, labels, *args, **kw)

    monkeypatch.setattr(jax_pipe, "weighted_bce_with_logits", loss)
    model = _Recorder(FlaxM5(classes_num=1, conv1_s2d=False))
    tx = jax_make_optimizer(1e-3)
    sample = jnp.zeros((batch, WCFG.frame_size, 1), jnp.float32)
    jstate = jax_init_state(model.model, jax.random.key(0), sample, tx)
    step = jax_pipe.make_waveform_train_step(model, tx, JWCFG, 5.0, augment=True, jit=False)
    step(jstate, jbufs, jnp.asarray(starts), rng)
    return np.transpose(model.x, (0, 2, 1)), seen["labels"]


def jax_waveform_draws(rng, batch, n_starts, shape):
    """sed_tpu's waveform augmentation draws (device_pipeline.py:238-254),
    in the port's AugmentDraws layout."""
    k_key, ptr_key, noise_key = jax.random.split(rng, 3)
    u_mix = jax.random.uniform(k_key, (batch,))
    ptr = jax.random.randint(ptr_key, (batch, jax_pipe.MAX_MIX), 0, n_starts)
    r_key, n_key = jax.random.split(noise_key)
    u_noise = jax.random.uniform(r_key, (batch, 1, 1))
    noise = jax.random.normal(n_key, shape, dtype=jnp.float32)
    return pipe.AugmentDraws(
        u_mix=torch.from_numpy(np.array(u_mix)),
        ptr=torch.from_numpy(np.array(ptr)).to(torch.int64),
        u_noise=torch.from_numpy(np.array(u_noise).reshape(batch)),
        noise=torch.from_numpy(np.array(noise)))


@pytest.mark.parametrize("seed", range(3))
def test_augmentation_apply_on_sed_tpu_draws(corpus, monkeypatch, seed):
    a, b = datasets(corpus)
    bufs = pipe.waveform_buffers_from_dataset(a, "cpu")
    jbufs = jax_pipe.waveform_buffers_from_dataset(b)
    batch = 8
    starts = a.possible_start_indices[8 * seed:8 * seed + batch]
    rng = jax.random.key(20 + seed)
    want_x, want_labels = sed_tpu_augmented(monkeypatch, jbufs, starts, rng, batch)
    gather = pipe.make_waveform_gather(WCFG)
    waves, labels = gather(bufs, torch.from_numpy(starts))
    draws = jax_waveform_draws(rng, batch, len(a), tuple(waves.shape))
    x, y = pipe.apply_augmentation(bufs, waves, labels, draws, gather, False,
                                   pipe.WAVE_MIX_CUM)
    assert x.shape == waves.shape and y.shape == labels.shape
    assert np.abs(x.numpy() - want_x).max() <= 1e-6
    np.testing.assert_array_equal(y.numpy(), want_labels)
    assert not torch.equal(x, waves)


def test_augmentation_multiclass_labels_take_the_union():
    class Store:
        long_waveform = np.random.default_rng(0).standard_normal((1, 400)).astype(np.float32)
        all_start_indices_labels = np.zeros((400, 3), bool)
        possible_start_indices = np.arange(300, dtype=np.int32)

    Store.all_start_indices_labels[100:200, 1] = True
    cfg = WaveformConfig(working_sample_rate=64, time_margin=0.5)   # frame 64
    bufs = pipe.waveform_buffers_from_dataset(Store(), "cpu")
    gather = pipe.make_waveform_gather(cfg)
    waves, labels = gather(bufs, torch.tensor([0, 10]))
    draws = pipe.AugmentDraws(u_mix=torch.tensor([0.99, 0.1]),
                              ptr=torch.tensor([[150, 5, 6], [150, 150, 150]]),
                              u_noise=torch.tensor([0.1, 0.1]), noise=torch.zeros(2, 1, 64))
    x, y = pipe.apply_augmentation(bufs, waves, labels, draws, gather, False,
                                   pipe.WAVE_MIX_CUM)
    # Crop 0 mixes three extra crops (u_mix 0.99), crop 1 none (0.1 <= 0.5).
    assert y.tolist() == [[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]
    want = (waves[0] + bufs.waveform[:, 150:214] + bufs.waveform[:, 5:69]
            + bufs.waveform[:, 6:70]) / 4
    torch.testing.assert_close(x[0], want)
    assert torch.equal(x[1], waves[1])


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def test_m5_uses_the_train_mode_batch_norm():
    bns = [m for m in M5(1).modules() if isinstance(m, torch.nn.BatchNorm1d)]
    assert len(bns) == 9 and all(isinstance(m, BatchNorm1d) for m in bns)


def test_batch_norm_1d_matches_flax():
    """Running statistics after several training forwards over (batch,
    length), and the output."""
    import flax.linen as nn

    rng = np.random.default_rng(5)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xs = [(rng.standard_normal((4, 9, 6)) * 2 + 0.5).astype(np.float32) for _ in range(4)]
    variables = flax_bn.init(jax.random.key(0), jnp.asarray(xs[0]))
    bn = BatchNorm1d(6, eps=1e-5).train()
    for x in xs:
        y_flax, upd = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        y = bn(torch.from_numpy(x).permute(0, 2, 1))
        assert np.abs(y.detach().permute(0, 2, 1).numpy() - np.asarray(y_flax)).max() <= 1e-5
    stats = np_tree(variables["batch_stats"])
    assert np.abs(bn.running_mean.numpy() - stats["mean"]).max() <= 1e-6
    assert np.abs(bn.running_var.numpy() - stats["var"]).max() <= 1e-6


# Each conv bias of M5 feeds a BatchNorm, which removes it: its gradient is
# zero up to rounding (float64: ~1e-17 of the weights'), so no comparison of
# it or of what Adam's first step makes of it means anything.
CONV_BIASES = (".0.bias", ".3.bias")


def sed_tpu_first_gradients(model, jstate, waves, labels):
    from sed_tpu.train.loss import weighted_bce_with_logits as jax_bce

    jx = jnp.asarray(waves.numpy().transpose(0, 2, 1))

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": jstate.batch_stats}, jx,
                             train=True, mutable=["batch_stats"])
        return jax_bce(out, jnp.asarray(labels.numpy()), 5.0, False)

    return m5_state_dict(np_tree(jax.grad(loss_fn)(jstate.params)),
                         np_tree(jstate.batch_stats))


def test_one_step_matches_sed_tpu(corpus):
    """Losses (two steps), first gradients, parameters and BatchNorm
    statistics after one step, from the same weights and batch.

    Adam's first step moves a weight by lr * g / (|g| + eps), about lr times
    the sign of g: it turns the float32 rounding of the gradients (~5e-6 of
    a tensor's largest |grad| here, either package's) into a step of up to
    2 lr where g is near zero.  So the parameters are compared where the
    gradient is clear of zero (|g| >= 1e-3 of the tensor's largest), which
    must be at least 90% of each tensor (98.6-100% here), and the gradients
    themselves everywhere.
    """
    a, b = datasets(corpus)
    batch = 8
    model, jstate, port = flax_m5(batch)
    tx = jax_make_optimizer(1e-3)
    bufs = pipe.waveform_buffers_from_dataset(a, "cpu")
    jbufs = jax_pipe.waveform_buffers_from_dataset(b)
    starts = a.possible_start_indices[:batch]
    jgrad = sed_tpu_first_gradients(
        model, jstate, *pipe.make_waveform_gather(WCFG)(bufs, torch.from_numpy(starts)))
    state = init_state(port, 1e-3, "cpu")
    jstep = jax_pipe.make_waveform_train_step(model, tx, JWCFG, 5.0, augment=False)
    step = pipe.make_waveform_train_step(WCFG, 5.0, augment=False)
    jstate, jloss = jstep(jstate, jbufs, jnp.asarray(starts), jax.random.key(1))
    np.testing.assert_allclose(float(step(state, bufs, starts)), float(jloss), rtol=1e-5)
    want = m5_state_dict(np_tree(jstate.params), np_tree(jstate.batch_stats))
    have = port.state_dict()
    for key, p in port.named_parameters():
        if key.endswith(CONV_BIASES):
            continue
        g, jg = p.grad, jgrad[key]
        scale = jg.abs().max().item()
        assert (g - jg).abs().max().item() <= 1e-4 * scale, (key, "gradient")
        clear = jg.abs() >= 1e-3 * scale
        assert clear.float().mean().item() >= 0.9, key
        err = (have[key] - want[key]).abs()[clear].max().item()
        assert err <= 1e-4 * want[key].abs().max().item(), (key, err)
    for key in [k for k in want if k.endswith(("running_mean", "running_var"))]:
        err = (have[key] - want[key]).abs().max().item()
        assert err <= 1e-4 * want[key].abs().max().item(), (key, err)
    jstate, jloss = jstep(jstate, jbufs, jnp.asarray(starts), jax.random.key(1))
    np.testing.assert_allclose(float(step(state, bufs, starts)), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == 2
    assert not bufs.waveform.requires_grad and bufs.waveform.grad is None


def test_waveform_step_draws_from_its_generator(corpus):
    a, _ = datasets(corpus)
    bufs = pipe.waveform_buffers_from_dataset(a, "cpu")
    starts = a.possible_start_indices[:4]
    step = pipe.make_waveform_train_step(WCFG, 5.0, augment=True)
    losses = []
    for seed in (1, 1, 2):
        state = init_state(M5(1), 1e-3, "cpu", seed=0)
        losses.append(float(step(state, bufs, starts, torch.Generator().manual_seed(seed))))
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# evaluate() and train()
# ---------------------------------------------------------------------------

def _record_logits(monkeypatch, module, sink):
    real = module._sigmoid_np

    def sigmoid(x):
        sink.append(np.asarray(x))
        return real(x)

    monkeypatch.setattr(module, "_sigmoid_np", sigmoid)


def test_evaluate_matches_sed_tpu(corpus, tmp_path, monkeypatch):
    a, b = datasets(corpus, val=0.34, seed=1)
    model, jstate, port = flax_m5(4, seed=2)
    g = torch.Generator().manual_seed(0)
    bs = np_tree(jstate.batch_stats)
    for j, m in enumerate(m for m in port.modules() if isinstance(m, BatchNorm1d)):
        m.running_mean.uniform_(-0.3, 0.3, generator=g)
        m.running_var.uniform_(0.5, 2.0, generator=g)
        bs[f"BatchNorm_{j}"] = {"mean": m.running_mean.numpy().copy(),
                                "var": m.running_var.numpy().copy()}
    jstate = jstate.replace(batch_stats=bs)
    ours, theirs = [], []
    _record_logits(monkeypatch, loop, ours)
    _record_logits(monkeypatch, jax_loop, theirs)
    got = loop.evaluate(port, init_state(port, 1e-3, "cpu"), a, "waveform", 5.0,
                        str(tmp_path), 0, make_plots=False, cfg=WCFG)
    want = jax_loop.evaluate(model, jstate, b, "waveform", 5.0, str(tmp_path), 0,
                             make_plots=False, cfg=JWCFG)
    assert len(ours) == len(theirs) == len(got[0]) == 2
    for x, y in zip(ours, theirs):
        assert x.shape == y.shape and x.shape[1] == 1
        assert np.abs(x - y).max() <= 1e-5
    losses, recalls, precisions, aps, event_ms = got
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    np.testing.assert_allclose(aps, want[3], atol=1e-6)
    for r, q in zip(recalls, want[1]):
        np.testing.assert_allclose(r, q, atol=1e-6)
    for r, q in zip(precisions, want[2]):
        np.testing.assert_allclose(r, q, atol=1e-6)
    assert event_ms == want[4]
    assert not port.training


def test_evaluate_pads_to_the_bucket_without_changing_scores(tmp_path):
    """Frames are independent in eval mode: 33 frames (padded to 64) score as
    each frame alone."""
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((33, 1, WCFG.frame_size)).astype(np.float32)

    class One:
        def get_validation_sampler(self, max_validate_num=None):
            yield frames, (rng.random(33) > 0.5).astype(np.float32), "val"

    port = M5(1, generator=torch.Generator().manual_seed(0))
    seen = []
    real = loop._sigmoid_np
    loop._sigmoid_np = lambda x: seen.append(x) or real(x)
    try:
        loop.evaluate(port, init_state(port, 1e-3, "cpu"), One(), "waveform", 5.0,
                      str(tmp_path), 0, make_plots=False, cfg=None)
    finally:
        loop._sigmoid_np = real
    with torch.no_grad():
        alone = torch.cat([port(torch.from_numpy(f[None])) for f in frames[[0, 32]]])
    assert seen[0].shape == (33, 1)
    assert np.abs(seen[0][[0, 32]] - alone.numpy()).max() <= 1e-5


def test_evaluate_plots_waveform_panels(corpus, tmp_path):
    pytest.importorskip("matplotlib")
    a, _ = datasets(corpus, val=0.5)
    port = M5(1)
    loop.evaluate(port, init_state(port, 1e-3, "cpu"), a, "waveform", 5.0,
                  str(tmp_path), 3, make_plots=True, cfg=WCFG)
    assert "AP-best.png" in os.listdir(tmp_path / "images" / "Iter-3")


def _recording_plotter(monkeypatch, module, cls, sink):
    class Recording(cls):
        def report_train_loss(self, value):
            sink.append(float(value))
            super().report_train_loss(value)

    monkeypatch.setattr(module, "ProgressPlotter", Recording)


def test_train_matches_sed_tpu_loop(corpus, tmp_path, monkeypatch):
    """Four steps at lr 1e-5 with an evaluation every two.  Adam's first
    steps are about lr times the sign of each gradient, so a weight whose
    float32 gradient lies within rounding of zero moves by up to 2 lr the
    other way in either package (test_one_step_matches_sed_tpu); at lr 1e-3
    that moves M5's later losses by ~1e-3 relative, at 1e-5 below 1e-5."""
    from sed_tpu.utils import progress as jax_progress
    from sed_tpu_torch.utils import progress

    a, b = datasets(corpus, val=0.34)
    batch, steps = 4, 4
    model, _, port = flax_m5(batch, lr=1e-5)
    ours, theirs = [], []
    _recording_plotter(monkeypatch, loop, progress.ProgressPlotter, ours)
    _recording_plotter(monkeypatch, jax_loop, jax_progress.ProgressPlotter, theirs)
    state = loop.train(port, a, "waveform", num_steps=steps, lr=1e-5, log_freq=2,
                       outputs_dir=str(tmp_path / "torch"), batch_size=batch, cfg=WCFG,
                       initial_state=init_state(port, 1e-5, "cpu"), make_plots=False,
                       limit_val_samples=1, device="cpu")
    jax_loop.train(model, b, "waveform", num_steps=steps, lr=1e-5, log_freq=2,
                   outputs_dir=str(tmp_path / "jax"), batch_size=batch, cfg=JWCFG,
                   make_plots=False, limit_val_samples=1)
    assert len(ours) == len(theirs) == steps and state.step == steps
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    recs = [[json.loads(line) for line in open(tmp_path / tag / "metrics.jsonl")]
            for tag in ("torch", "jax")]
    assert [r["iteration"] for r in recs[0]] == [2, 4]
    for r, q in zip(*recs):
        assert set(r) == set(q)
        np.testing.assert_allclose(r["train_loss"], q["train_loss"], rtol=1e-5)
    assert sorted(os.listdir(tmp_path / "torch" / "checkpoints")) == \
        ["iteration_2.pt", "iteration_4.pt"]


# ---------------------------------------------------------------------------
# The training CLI with its defaults (Waveform, M5)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def film_clap_root(tmp_path_factory):
    """A FilmClap-layout corpus: 3 x 6 s clips at 48 kHz, one 1 s tonal
    burst each (its centres 0.33 s apart label it)."""
    root = tmp_path_factory.mktemp("film")
    film_dir = root / "FilmClap" / "filmA"
    film_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    sr = DEFAULT_WAVEFORM.working_sample_rate
    labels = {}
    for i in range(3):
        sig = 0.01 * rng.standard_normal(6 * sr)
        start = 2.0 + 0.5 * i
        t = np.arange(sr) / sr
        sig[int(start * sr):int(start * sr) + sr] += 0.5 * np.sin(2 * np.pi * 2000 * t)
        path = str(film_dir / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        labels[path] = [start + 0.33, start + 0.66]
    with open(root / "FilmClap" / "paths_and_labels_fixed_Meron.txt", "w") as f:
        json.dump(labels, f)
    return str(root)


def test_train_cli_defaults_train_m5(film_clap_root, tmp_path):
    outputs_root = str(tmp_path / "training")
    cli_main.main(["--dataset_dir", film_clap_root, "--outputs_root", outputs_root,
                   "--val_descriptor", "clip_2", "--batch_size", "2", "--num_train_steps", "2",
                   "--log_freq", "2", "--device", "cpu", "--no_plot"])
    (run,) = os.listdir(outputs_root)
    assert run.startswith("FilmClap_cfg(WaveForm_SaR-48.0K_FrS-31.7K_HoS-15.8K_Ch-1_b2")
    ckpt = os.path.join(outputs_root, run, "checkpoints", "iteration_2.pt")
    with open(os.path.join(outputs_root, run, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["iteration"] == 2 and np.isfinite(rec["train_loss"]) and \
        np.isfinite(rec["val_loss"])
    model = cli_infer.load_model(ckpt, 1, arch="M5")
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 2
    for key, value in saved["model"].items():
        assert torch.equal(model.state_dict()[key], value), key
    wav = sorted(json.load(open(os.path.join(
        film_clap_root, "FilmClap", "paths_and_labels_fixed_Meron.txt"))))[0]
    scores = cli_infer.predict_file_m5(model, wav, DEFAULT_WAVEFORM, device="cpu")
    # 6 s at 48 kHz: 1 + (288000 - 31680) // 15840 = 17 frames.
    assert scores.shape == (17, 1) and ((scores >= 0) & (scores <= 1)).all()


def test_train_cli_refuses_another_model_with_waveform(tmp_path):
    with pytest.raises(ValueError, match="waveform training uses M5"):
        cli_main.main(["--dataset_dir", str(tmp_path), "--model", "MobileNetV1",
                       "--device", "cpu", "--no_plot"])
    assert not os.listdir(tmp_path)

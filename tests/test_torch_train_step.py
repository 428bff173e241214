"""The port's train step against sed_tpu's, on the CPU.

Tolerances: the loss within rtol 1e-6 of sed_tpu's (as tests/test_train.py
holds sed_tpu against torch); the AMSGrad trajectory within rtol 1e-4,
atol 1e-6 of sed_tpu's optax one over 500 steps (tests/test_train.py's
tolerance); train-mode BatchNorm's running statistics within 1e-6 of
flax's; gather, transform and augmentation within 1e-6 (Complex mode's
log-mel: 1e-4 dB); one whole step from the same weights: loss, parameters
and BatchNorm statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.data import device_pipeline as jax_pipe
from sed_tpu.models import cnn as jax_cnn
from sed_tpu.train import loss as jax_loss
from sed_tpu.train import optim as jax_optim
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.models import cnn
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict, mobilenet_state_dict
from sed_tpu_torch.models.layers import BatchNorm2d
from sed_tpu_torch.train import loss, optim
from sed_tpu_torch.train.state import init_state, make_train_step

CFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
JCFG = JaxSpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
SMALL = ((8, 2), (16, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Loss and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_weight", [1.0, 5.0])
@pytest.mark.parametrize("frames", [(24, 30), (32, 31), (16, 16)])
def test_weighted_bce_multi_frame_matches_sed_tpu(pos_weight, frames):
    rng = np.random.default_rng(frames[0])
    logits = (3 * rng.standard_normal((4, frames[0], 2))).astype(np.float32)
    targets = (rng.random((4, frames[1], 2)) > 0.5).astype(np.float32)
    want = float(jax_loss.weighted_bce_with_logits(jnp.asarray(logits), jnp.asarray(targets),
                                                   pos_weight, True))
    got = loss.weighted_bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets),
                                        pos_weight, True)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(
        loss.weighted_bce_with_logits_np(logits, targets, pos_weight, True),
        jax_loss.weighted_bce_with_logits_np(logits, targets, pos_weight, True), rtol=1e-12)


def test_weighted_bce_single_frame_matches_sed_tpu():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((8, 1)).astype(np.float32)
    targets = (rng.random(8) > 0.5).astype(np.float32)
    want = float(jax_loss.weighted_bce_with_logits(jnp.asarray(logits), jnp.asarray(targets),
                                                   5.0, False))
    got = loss.weighted_bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets),
                                        5.0, False)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(loss.weighted_bce_with_logits_np(logits, targets, 5.0, False),
                               jax_loss.weighted_bce_with_logits_np(logits, targets, 5.0, False),
                               rtol=1e-12)


@pytest.mark.parametrize("step", [0, 1, 199, 200, 399, 400, 1000, 12345])
def test_lr_schedule_matches_sed_tpu(step):
    assert optim.reference_lr_schedule(1e-3)(step) == jax_optim.reference_lr_schedule(1e-3)(step)


def test_scheduler_gives_update_t_the_decay_of_t():
    """LambdaLR stepped after each update: update t uses base * 0.997**(t//200),
    as optax evaluates the schedule at the count before the update."""
    p = torch.nn.Linear(2, 1)
    opt, sched = optim.make_optimizer(p, 1e-3)
    for t in range(450):
        assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.997 ** (t // 200), rel=1e-12)
        opt.step()
        sched.step()
    g = opt.param_groups[0]
    assert g["amsgrad"] and g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
    assert g["weight_decay"] == 0.0


def test_amsgrad_trajectory_matches_sed_tpu():
    """500 updates on a fixed gradient stream, across the decay at 200."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(16).astype(np.float32)
    grads = rng.standard_normal((500, 16)).astype(np.float32)
    base_lr = 1e-3

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = optim.make_optimizer(model, base_lr)
    ours = []
    for g in grads:
        opt.zero_grad()
        model.w.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        ours.append(model.w.detach().numpy().copy())

    tx = jax_optim.make_optimizer(base_lr)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    theirs = []
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        theirs.append(np.asarray(params))
    np.testing.assert_allclose(np.stack(ours), np.stack(theirs), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Train-mode BatchNorm
# ---------------------------------------------------------------------------

def test_train_mode_batch_norm_matches_flax():
    """Running statistics after several training forwards, and the output."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xs = [(rng.standard_normal((4, 5, 3, 6)) * 2 + 0.5).astype(np.float32) for _ in range(4)]
    variables = flax_bn.init(jax.random.key(0), jnp.asarray(xs[0]))
    bn = BatchNorm2d(6, eps=1e-5)
    bn.train()
    for x in xs:
        y_flax, upd = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert np.abs(y.detach().permute(0, 2, 3, 1).numpy() - np.asarray(y_flax)).max() <= 1e-5
    stats = np_tree(variables["batch_stats"])
    assert np.abs(bn.running_mean.numpy() - stats["mean"]).max() <= 1e-6
    assert np.abs(bn.running_var.numpy() - stats["var"]).max() <= 1e-6
    # torch's own layer stores the unbiased variance: farther off.
    plain = torch.nn.BatchNorm2d(6, eps=1e-5).train()
    for x in xs:
        plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(plain.running_var.numpy() - stats["var"]).max() > 1e-3
    bn.eval()
    x = torch.from_numpy(xs[0]).permute(0, 3, 1, 2)
    torch.testing.assert_close(bn(x), torch.nn.functional.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, 1e-5))


def test_models_use_the_train_mode_batch_norm():
    for model in (cnn.CnnAvgPooling(1, SMALL), cnn.MobileNetV1(1)):
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        assert bns and all(isinstance(m, BatchNorm2d) for m in bns)


# ---------------------------------------------------------------------------
# Gather, transform, augmentation
# ---------------------------------------------------------------------------

class _Store:
    """A packed store like SpectrogramDataset's training split."""

    def __init__(self, complex_mode, seed=0, frames=140, bins=None):
        rng = np.random.default_rng(seed)
        bins = bins or (CFG.freq_bins if complex_mode else CFG.mel_bins)
        shape = (1, frames, bins)
        if complex_mode:
            f = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        else:
            f = rng.standard_normal(shape).astype(np.float32)
        self.train_features = f
        self.train_event_matrix = (rng.random((frames, 2)) > 0.7).astype(np.float32)
        self.train_start_indices = rng.permutation(frames - CFG.train_crop_size).astype(np.int32)
        self.mean = f.mean(axis=(0, 1))
        self.std = f.std(axis=(0, 1))


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
def test_gather_and_transform_match_sed_tpu(mode):
    store = _Store(mode == "Complex")
    bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    jbufs = jax_pipe.spectrogram_buffers_from_dataset(store)
    starts = store.train_start_indices[:6]
    f, e = pipe.make_gather_crops(CFG)(bufs, torch.from_numpy(starts))
    jf, je = jax_pipe.make_gather_crops(JCFG)(jbufs, jnp.asarray(starts))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    x = pipe.make_transform(CFG, mode)(bufs, f)
    jx = jax_pipe.make_transform(JCFG, mode)(jbufs, jf)
    assert x.shape == jx.shape == (6, 1, CFG.train_crop_size, CFG.mel_bins)
    tol = 1e-4 if mode == "Complex" else 1e-6
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= tol


def jax_draws(rng, batch, n_starts, feats_shape, complex_mode):
    """sed_tpu's augmentation draws (device_pipeline.py:99-181), in the
    port's AugmentDraws layout."""
    k_key, ptr_key, noise_key = jax.random.split(rng, 3)
    u_mix = jax.random.uniform(k_key, (batch,))
    ptr = jax.random.randint(ptr_key, (batch, jax_pipe.MAX_MIX), 0, n_starts)
    r_key, n_key = jax.random.split(noise_key)
    u_noise = jax.random.uniform(r_key, (batch,) + (1,) * (len(feats_shape) - 1))
    noise = np.asarray(jax.random.normal(n_key, feats_shape, dtype=jnp.float32))
    if complex_mode:
        noise = noise[..., 0]
    return pipe.AugmentDraws(
        u_mix=torch.from_numpy(np.array(u_mix)),
        ptr=torch.from_numpy(np.array(ptr)).to(torch.int64),
        u_noise=torch.from_numpy(np.asarray(u_noise).reshape(batch)),
        noise=torch.from_numpy(noise.copy()))


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
@pytest.mark.parametrize("seed", range(3))
def test_augmentation_apply_on_sed_tpu_draws(mode, seed):
    complex_mode = mode == "Complex"
    store = _Store(complex_mode, seed=seed, bins=None if not complex_mode else 40)
    bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    jbufs = jax_pipe.spectrogram_buffers_from_dataset(store)
    batch = 16
    starts = store.train_start_indices[:batch]
    f, e = pipe.make_gather_crops(CFG)(bufs, torch.from_numpy(starts))
    jf, je = jax_pipe.make_gather_crops(JCFG)(jbufs, jnp.asarray(starts))
    rng = jax.random.key(10 + seed)
    jf2, je2 = jax_pipe.make_augment_batch(JCFG, mode)(rng, jbufs, jf, je)
    draws = jax_draws(rng, batch, len(starts), tuple(jf.shape), complex_mode)
    draws.ptr = torch.from_numpy(np.array(jax.random.randint(
        jax.random.split(rng, 3)[1], (batch, pipe.MAX_MIX), 0,
        store.train_start_indices.shape[0]))).to(torch.int64)
    f2, e2 = pipe.apply_augmentation(bufs, f, e, draws, pipe.make_gather_crops(CFG),
                                     complex_mode)
    assert f2.shape == f.shape
    assert np.abs(f2.numpy() - np.asarray(jf2)).max() <= 1e-6
    np.testing.assert_array_equal(e2.numpy(), np.asarray(je2))
    assert not torch.equal(f2, f)   # the mix or the noise changed something


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
def test_augmentation_draws_are_seeded(mode):
    complex_mode = mode == "Complex"
    store = _Store(complex_mode, bins=None if not complex_mode else 40)
    bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    f, e = pipe.make_gather_crops(CFG)(bufs, torch.from_numpy(store.train_start_indices[:8]))
    aug = pipe.make_augment_batch(CFG, mode)
    a = aug(torch.Generator().manual_seed(1), bufs, f, e)
    b = aug(torch.Generator().manual_seed(1), bufs, f, e)
    c = aug(torch.Generator().manual_seed(2), bufs, f, e)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    d = pipe.draw_augmentation(torch.Generator().manual_seed(1), bufs, f.shape, complex_mode)
    assert d.noise.shape == (f.shape[:-1] if complex_mode else f.shape)
    assert int(d.ptr.max()) < len(store.train_start_indices)


# ---------------------------------------------------------------------------
# One whole step from the same weights
# ---------------------------------------------------------------------------

def _flax_and_port(arch):
    if arch == "CnnAvgPooling":
        model = jax_cnn.CnnAvgPooling(classes_num=2, model_config=SMALL)
        port = cnn.CnnAvgPooling(2, SMALL)
        to_sd = cnn_avg_pooling_state_dict
    else:
        model = jax_cnn.MobileNetV1(classes_num=2, emit="logits")
        port = cnn.MobileNetV1(2, emit="logits")
        to_sd = mobilenet_state_dict
    return model, port, to_sd


def _step_inputs(arch, mode, lr):
    complex_mode = mode == "Complex"
    store = _Store(complex_mode, seed=4)
    bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    jbufs = jax_pipe.spectrogram_buffers_from_dataset(store)
    batch = 8
    model, port, to_sd = _flax_and_port(arch)
    tx = jax_optim.make_optimizer(lr)
    sample = jnp.zeros((batch, CFG.train_crop_size, CFG.mel_bins, 1))
    jstate = jax_init_state(model, jax.random.key(0), sample, tx)
    port.load_state_dict(to_sd(np_tree(jstate.params), np_tree(jstate.batch_stats)))
    starts = store.train_start_indices[:batch]
    return store, bufs, jbufs, model, port, to_sd, tx, jstate, starts


def _assert_state_close(port, want, what, skip=()):
    have = port.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked") or key.startswith("bn0.") or \
                any(s in key for s in skip):
            continue
        err = (have[key] - value).abs().max().item()
        assert err <= 1e-5, (what, key, err)


@pytest.mark.parametrize("arch,mode", [("CnnAvgPooling", "logMel"),
                                       ("CnnAvgPooling", "Complex"),
                                       ("MobileNetV1", "logMel")])
def test_one_step_matches_sed_tpu(arch, mode):
    """Loss (two steps), BatchNorm statistics and parameters after one step.

    MobileNetV1's parameters are not compared: at this size (30 frames, 8
    crops) its float32 gradients, the port's and sed_tpu's alike, lie ~1%
    from the float64 gradient (test_gradients_match_float64 below), and
    Adam's first update moves each weight by about lr times the sign of its
    gradient, so a weight whose gradient is within that noise of zero moves
    either way.  Its BatchNorm statistics and first loss are compared (the
    second loss follows from those weights).
    """
    _, bufs, jbufs, model, port, to_sd, tx, jstate, starts = _step_inputs(arch, mode, 1e-3)
    state = init_state(port, 1e-3, "cpu")
    jstep = jax_pipe.make_spectrogram_train_step(model, tx, JCFG, 5.0, mode, augment=False)
    step = pipe.make_spectrogram_train_step(CFG, 5.0, mode, augment=False)
    jstate, jloss = jstep(jstate, jbufs, jnp.asarray(starts), jax.random.key(1))
    np.testing.assert_allclose(float(step(state, bufs, starts)), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    want = to_sd(np_tree(jstate.params), np_tree(jstate.batch_stats))
    skip = (".weight", ".bias") if arch == "MobileNetV1" else ()
    _assert_state_close(port, want, "one step", skip)
    if arch != "MobileNetV1":
        jstate, jloss = jstep(jstate, jbufs, jnp.asarray(starts), jax.random.key(1))
        np.testing.assert_allclose(float(step(state, bufs, starts)), float(jloss), rtol=1e-5)
    else:   # bn0: never called, never updated
        have = port.state_dict()
        assert torch.equal(have["bn0.weight"], torch.ones(64))
        assert torch.equal(have["bn0.running_var"], torch.ones(64))
        assert port.bn0.weight.grad is None


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
def test_gradients_match_float64(mode):
    """CnnAvgPooling: the port's float32 gradient lies within twice
    sed_tpu's float32 distance from the float64 gradient (the port's model
    in float64), plus 1e-6 of each tensor's largest |grad|.

    MobileNetV1 is left out: at this size some of its fc1 pre-activations
    lie within float32 rounding of ReLU's kink, so either package's float32
    gradient differs from the float64 one by up to ~10% of fc1's largest
    output gradient, by which units happen to flip (measured on this
    input), and a bound between the two packages would measure that luck.
    """
    arch = "CnnAvgPooling"
    _, bufs, jbufs, model, port, to_sd, _, jstate, starts = _step_inputs(arch, mode, 1e-3)
    jf, je = jax_pipe.make_gather_crops(JCFG)(jbufs, jnp.asarray(starts))
    jx = jnp.transpose(jax_pipe.make_transform(JCFG, mode)(jbufs, jf), (0, 2, 3, 1))

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": jstate.batch_stats}, jx,
                             train=True, mutable=["batch_stats"])
        return jax_loss.weighted_bce_with_logits(out, je, 5.0, True)

    jgrad = to_sd(np_tree(jax.grad(loss_fn)(jstate.params)), np_tree(jstate.batch_stats))
    f, e = pipe.make_gather_crops(CFG)(bufs, torch.from_numpy(starts))
    x = pipe.make_transform(CFG, mode)(bufs, f)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = port.to(dtype).train()
        m.zero_grad(set_to_none=True)
        loss.weighted_bce_with_logits(m(x.to(dtype)), e.to(dtype), 5.0, True).backward()
        grads[dtype] = {k: v.grad.detach().clone() for k, v in m.named_parameters()
                        if v.grad is not None}
    for key, g64 in grads[torch.float64].items():
        scale = g64.abs().max().item()
        ours = (grads[torch.float32][key].double() - g64).abs().max().item()
        theirs = (jgrad[key].double() - g64).abs().max().item()
        assert ours <= 2 * theirs + 1e-6 * scale, (key, ours, theirs, scale)


def test_make_train_step_on_ready_batches():
    """state.make_train_step (x, y given) against sed_tpu's, from the same weights."""
    from sed_tpu.train.state import make_train_step as jax_make_train_step

    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 16, 64, 1)).astype(np.float32)
    y = (rng.random((8, 16, 1)) > 0.5).astype(np.float32)
    model, port, to_sd = _flax_and_port("CnnAvgPooling")
    tx = jax_optim.make_optimizer(1e-3)
    jstate = jax_init_state(model, jax.random.key(1), jnp.asarray(x), tx)
    port = cnn.CnnAvgPooling(1, SMALL)
    model = jax_cnn.CnnAvgPooling(classes_num=1, model_config=SMALL)
    jstate = jax_init_state(model, jax.random.key(1), jnp.asarray(x), tx)
    port.load_state_dict(to_sd(np_tree(jstate.params), np_tree(jstate.batch_stats)))
    state = init_state(port, 1e-3, "cpu")
    jstep = jax_make_train_step(model, tx, pos_weight=1.0, multi_frame=True)
    step = make_train_step(pos_weight=1.0, multi_frame=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    for _ in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        got = step(state, xt, torch.from_numpy(y))
        np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)


def test_init_state_seeds_the_weights():
    a = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=3).model.state_dict()
    b = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=3).model.state_dict()
    c = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=4).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_blocks.0.conv1.weight"], c["conv_blocks.0.conv1.weight"])

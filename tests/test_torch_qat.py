"""The port's QAT (``models/qat.py``) against sed_tpu's (CPU).

Sizes and recipe are sed_tpu's tests/test_qat.py: CnnAvgPooling with the
small stack ((8, 2), (16, 2), (32, 1)) on 8 x 30 frames (TRAIN_CHANNEL_AND_POOL
for the export check), flax's init and two train-mode passes, carried over
by ``models.convert``.  Tolerances: the STE's values and gradient as
sed_tpu's test states them (1e-6); ``qat_export(qat_init(...))`` equal to
``quantize_cnn`` bit for bit; the fake-quant forward within 2e-3 of the int8
serving forward (sed_tpu's band); from one trainable state, in float64,
the port's losses within 1e-4 relative of sed_tpu's for 5 Adam steps; distillation
lowers the int8 deviation from the float model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.models import qat as jqat
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.models.qat import (qat_cnn_forward, qat_export, qat_finetune, qat_init,
                                      ste_fake_quant)
from sed_tpu_torch.models.quantize import quantize_cnn, quantized_scores

SMALL_CONFIG = ((8, 2), (16, 2), (32, 1))
FRAMES, MEL = 30, 64
LOSS_REL = 1e-4
STEPS, LR = 5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trained_ish(config, seed, batch=8):
    """(flax model, params, stats, NHWC x, port model): sed_tpu's recipe."""
    flax_model = FlaxCnn(classes_num=1, model_config=config)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((batch, FRAMES, MEL, 1)),
                    jnp.float32)
    # Jitted: one compile each, in place of an eager compile per operation.
    variables = jax.jit(lambda k, v: flax_model.init(k, v, train=False))(
        jax.random.key(seed), x)
    params, stats = variables["params"], variables["batch_stats"]
    train_pass = jax.jit(lambda p, s, v: flax_model.apply(
        {"params": p, "batch_stats": s}, v, train=True, mutable=["batch_stats"])[1])
    for _ in range(2):
        stats = train_pass(params, stats, x)["batch_stats"]
    port = CnnAvgPooling(1, config)
    port.load_state_dict(cnn_avg_pooling_state_dict(jax.tree.map(np.asarray, params),
                                                    jax.tree.map(np.asarray, stats)))
    return flax_model, params, stats, np.asarray(x), port.eval()


def nchw(x):
    return torch.from_numpy(np.array(np.transpose(x, (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def small():
    return trained_ish(SMALL_CONFIG, 2)


def test_ste_fake_quant_forward_and_gradient():
    """sed_tpu's numbers (tests/test_qat.py:39-48), and sed_tpu's function
    on the same input."""
    scale = torch.tensor(0.5)
    values = [0.1, 0.26, -0.3, 70.0, -70.0, 63.49]
    x = torch.tensor(values, requires_grad=True)
    y = ste_fake_quant(x, scale)
    np.testing.assert_allclose(y.detach().numpy(), [0.0, 0.5, -0.5, 63.5, -63.5, 63.5],
                               atol=1e-6)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1, 1, 1, 0, 0, 1], atol=1e-6)
    xj = jnp.asarray(values, jnp.float32)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jqat.ste_fake_quant(xj, jnp.float32(0.5))))
    gj = jax.grad(lambda v: jqat.ste_fake_quant(v, jnp.float32(0.5)).sum())(xj)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(gj))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weight_fake_quant_follows_sed_tpus_jitted_step(dtype):
    """The weight fake-quant's values and gradients equal sed_tpu's under
    ``jax.jit`` (its fine-tune step), in either dtype: XLA multiplies the
    absmax by 1/127 rounded to the weights' dtype, and whether a channel's
    largest weight lands inside, on or beyond the clip follows from it."""
    from sed_tpu_torch.models.qat import _weight_fake_quant

    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 32, 3, 3)).astype(dtype)        # OIHW
    r = rng.standard_normal(w.shape).astype(dtype)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = _weight_fake_quant(wt)
    (y * torch.from_numpy(r)).sum().backward()
    hwio = (2, 3, 1, 0)
    with jax.enable_x64(dtype == "float64"):
        fn = jax.jit(jax.value_and_grad(
            lambda v, u: (jqat._weight_fake_quant(v) * u).sum()))
        value, grad = fn(jnp.asarray(np.transpose(w, hwio)), jnp.asarray(np.transpose(r, hwio)))
        yj = jax.jit(jqat._weight_fake_quant)(jnp.asarray(np.transpose(w, hwio)))
        assert yj.dtype == dtype
    np.testing.assert_array_equal(y.detach().numpy(), np.transpose(np.asarray(yj), (3, 2, 0, 1)))
    np.testing.assert_array_equal(wt.grad.numpy(), np.transpose(np.asarray(grad), (3, 2, 0, 1)))


def test_qat_export_without_finetune_equals_ptq():
    """qat_init + qat_export with untouched weights is PTQ, tensor for tensor
    (at full width: the port's own model with seeded BatchNorm statistics)."""
    g = torch.Generator().manual_seed(1)
    port = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=g)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn(8, 1, FRAMES, MEL, generator=g)
    ptq = quantize_cnn(port, [x])
    exported = qat_export(*qat_init(port, [x]))
    assert exported["interp"] == ptq["interp"]
    assert exported["dense"].keys() == ptq["dense"].keys()
    for key in ptq["dense"]:
        assert torch.equal(exported["dense"][key], ptq["dense"][key]), key
    for la, lb in zip(exported["layers"], ptq["layers"]):
        assert la["pool"] == lb["pool"]
        for ca, cb in zip(la["convs"], lb["convs"]):
            assert ca.keys() == cb.keys()
            for key in cb:
                assert ca[key].dtype == cb[key].dtype and torch.equal(ca[key], cb[key]), key
    np.testing.assert_array_equal(quantized_scores(exported, x).numpy(),
                                  quantized_scores(ptq, x).numpy())


def test_qat_forward_matches_int8_serving_forward(small):
    """The fake-quant forward follows the int8 serving forward: the same
    lattice values, so the scores agree to float summation noise."""
    _, _, _, x, port = small
    trainable, static = qat_init(port, [nchw(x)])
    with torch.no_grad():
        fq = torch.sigmoid(qat_cnn_forward(trainable, static, nchw(x))).numpy()
    int8 = quantized_scores(qat_export(trainable, static), nchw(x)).numpy()
    assert fq.shape == int8.shape
    np.testing.assert_allclose(fq, int8, atol=2e-3)


def flax_state(trainable, static):
    """The port's (trainable, static) QAT state in sed_tpu's layouts (HWIO
    conv weights, an (in, out) dense weight)."""
    t = lambda a, axes=None: jnp.asarray(  # noqa: E731
        np.transpose(a.numpy(), axes) if axes else a.numpy())
    blocks = [{"w": [t(w, (2, 3, 1, 0)) for w in blk["w"]], "g": [t(g) for g in blk["g"]],
               "b": [t(b) for b in blk["b"]]} for blk in trainable["blocks"]]
    return ({"blocks": blocks, "dense": {"w": t(trainable["dense"]["w"], (1, 0)),
                                         "b": t(trainable["dense"]["b"])}},
            {"act_scales": [jnp.float32(float(s)) for s in static["act_scales"]],
             "pools": tuple(static["pools"]), "interp": int(static["interp"])})


def test_distill_losses_follow_sed_tpu(small):
    """From one trainable state (the port's ``qat_init``, carried to
    sed_tpu's layouts; its scales and affines are ``quantize_cnn``'s, held
    against sed_tpu's in test_torch_quantize.py), in float64 as the port's
    training is held against the CPU: the distillation loss at each of 5
    Adam steps (the state after k steps, scored on the k-th example) within
    1e-4 relative of sed_tpu's.  (In float32 the two summation orders flip
    fake-quant roundings, and the two runs part within a few steps.)"""
    flax_model, params, stats, x, port = small
    x2 = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    teacher = jax.jit(lambda v: flax_model.apply({"params": params, "batch_stats": stats}, v,
                                                 train=False))
    examples = [(xi.astype(np.float64), np.asarray(teacher(jnp.asarray(xi)), np.float64))
                for xi in (x, x2)]
    p_tr, p_st = qat_init(port, [nchw(x), nchw(x2)])
    p_tr = {"blocks": [{k: [t.double() for t in v] for k, v in b.items()}
                       for b in p_tr["blocks"]],
            "dense": {k: v.double() for k, v in p_tr["dense"].items()}}
    port_examples = [(nchw(xi).numpy(), t) for xi, t in examples]
    worst = 0.0
    with jax.enable_x64(True):
        j_tr, j_st = flax_state(p_tr, p_st)
        # One compile of sed_tpu's fake-quant loss, in place of an eager one per operation.
        j_loss = jax.jit(lambda tr, v, t: jnp.mean((jqat.qat_cnn_forward(tr, j_st, v) - t) ** 2))
        for k in range(STEPS):
            xk, tk = examples[k % 2]
            j_k = jqat.qat_finetune(j_tr, j_st, examples, mode="distill", steps=k, lr=LR)
            assert j_k["dense"]["w"].dtype == jnp.float64
            want = float(j_loss(j_k, jnp.asarray(xk), jnp.asarray(tk)))
            p_k = qat_finetune(p_tr, p_st, port_examples, mode="distill", steps=k, lr=LR,
                               device="cpu")
            with torch.no_grad():
                got = float(torch.mean((qat_cnn_forward(p_k, p_st, nchw(xk))
                                        - torch.from_numpy(tk)) ** 2))
            assert abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
            worst = max(worst, abs(got - want) / abs(want))
    print(f"distill losses over {STEPS} float64 steps: largest relative difference {worst:.3e}")


def test_distill_finetune_improves_int8_fidelity(small):
    _, _, _, x, port = small
    x2 = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    xs = [nchw(x), nchw(x2)]
    with torch.no_grad():
        logits = [port(xi) for xi in xs]
    trainable, static = qat_init(port, xs)

    def max_dev(tr):
        return max(float((quantized_scores(qat_export(tr, static), xi)
                          - torch.sigmoid(li)).abs().max()) for xi, li in zip(xs, logits))

    before = max_dev(trainable)
    tuned = qat_finetune(trainable, static, [(xi.numpy(), li.numpy()) for xi, li in
                                             zip(xs, logits)],
                         mode="distill", steps=60, lr=1e-4, device="cpu")
    after = max_dev(tuned)
    assert before > 1e-5, "PTQ already exact; the test cannot discriminate"
    assert after < before, (before, after)


def test_bce_finetune_reduces_its_loss(small):
    from sed_tpu_torch.train.loss import weighted_bce_with_logits

    _, _, _, x, port = small
    xt = nchw(x[:4])
    y = torch.from_numpy((np.random.default_rng(9).random((4, FRAMES, 1)) < 0.3)
                         .astype(np.float32))
    trainable, static = qat_init(port, [xt])

    def loss(tr):
        with torch.no_grad():
            return float(weighted_bce_with_logits(qat_cnn_forward(tr, static, xt), y))

    before = loss(trainable)
    tuned = qat_finetune(trainable, static, [(xt.numpy(), y.numpy())], mode="bce", steps=40,
                         lr=3e-4, device="cpu")
    assert loss(tuned) < before
    # The state keeps its dtype, as sed_tpu's pytree does (float64 here).
    tr64 = {"blocks": [{k: [t.double() for t in v] for k, v in b.items()}
                       for b in trainable["blocks"]],
            "dense": {k: v.double() for k, v in trainable["dense"].items()}}
    tuned64 = qat_finetune(tr64, static, [(xt.numpy(), y.numpy())], mode="bce", steps=2,
                           lr=3e-4, device="cpu")
    assert tuned64["dense"]["w"].dtype == tuned64["blocks"][0]["w"][0].dtype == torch.float64
    with pytest.raises(ValueError, match="distill"):
        qat_finetune(trainable, static, [(xt.numpy(), y.numpy())], mode="mse", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            qat_finetune(trainable, static, [(xt.numpy(), y.numpy())], steps=1)

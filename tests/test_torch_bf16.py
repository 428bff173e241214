"""The bf16 serving tier of the port's models against sed_tpu's (CPU).

``sed_tpu``'s models take flax's ``dtype``: with bfloat16 the convolutions,
dense layers and pools compute in bfloat16, the batch norms normalize in
float32 from float32 statistics, the parameters stay float32 and the
logits return as float32.  The port's ``dtype=torch.bfloat16`` does the
same (``models/layers.py``).  Both are held to sed_tpu's bands for the tier
on the same weights and inputs: 0.15 on logits (tests/test_models.py:166)
and 0.05 on sigmoid scores (tests/test_stream_pool.py:737).  Each test
prints the port's bf16 against its float32 beside sed_tpu's.  Sizes as
sed_tpu's tests: CnnAvgPooling ((8, 2), (16, 2)), 32 frames, M5 at 8 kHz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu_torch.cli import infer as cli
from sed_tpu_torch.configs import WaveformConfig
from sed_tpu_torch.models.cnn import CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          mobilenet_state_dict)
from sed_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d
from sed_tpu_torch.models.m5 import M5

NARROW = ((8, 2), (16, 2))
JWCFG = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33)
LOGIT_BAND = 0.15
SCORE_BAND = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(flax_model, sample, seed):
    variables = jax.jit(lambda k, v: flax_model.init(k, v, train=False))(
        jax.random.key(seed), sample)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3), "mean": (-0.5, 0.5),
                  "var": (0.5, 2.0)}.get(path[-1].key, (None, None))
        a = np.asarray(a)
        return a if lo is None else rng.uniform(lo, hi, a.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(draw, variables["params"]),
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]))


def family(arch):
    """(flax module of a dtype, port module of a dtype, converter, NCHW/NCW
    input, flax input)."""
    rng = np.random.default_rng(11)
    if arch == "M5":
        x = (0.1 * rng.standard_normal((2, 1, JWCFG.frame_size))).astype(np.float32)
        return (lambda d: FlaxM5(classes_num=1, dtype=d), lambda d: M5(1, dtype=d),
                m5_state_dict, x, np.transpose(x, (0, 2, 1)))
    x = rng.standard_normal((2, 1, 32, 64)).astype(np.float32)
    if arch == "MobileNetV1":
        return (lambda d: FlaxMobileNetV1(classes_num=1, emit="logits", dtype=d),
                lambda d: MobileNetV1(1, emit="logits", dtype=d), mobilenet_state_dict, x,
                np.transpose(x, (0, 2, 3, 1)))
    return (lambda d: FlaxCnn(classes_num=1, model_config=NARROW, dtype=d),
            lambda d: CnnAvgPooling(1, NARROW, dtype=d), cnn_avg_pooling_state_dict, x,
            np.transpose(x, (0, 2, 3, 1)))


@pytest.fixture(scope="module", params=["CnnAvgPooling", "MobileNetV1", "M5"])
def pair(request):
    """{dtype name: (sed_tpu's logits, the port's logits)} of one family on
    the same seeded weights and input, and the port's bf16 model."""
    flax_of, port_of, convert, x, fx = family(request.param)
    params, stats = seeded(flax_of(jnp.float32), jnp.asarray(fx), 3)
    out = {}
    for name, jd, td in (("f32", jnp.float32, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        jmodel, port = flax_of(jd), port_of(td)
        port.load_state_dict(convert(params, stats), strict=True)
        theirs = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                         jnp.asarray(fx), train=False))
        with torch.no_grad():
            ours = port.eval()(torch.from_numpy(x))
        out[name] = (theirs, ours)
    return request.param, out, port


def sigmoid(a):
    return 1.0 / (1.0 + np.exp(-a))


def test_bf16_logits_and_scores_follow_sed_tpu(pair):
    arch, out, _ = pair
    theirs, ours = out["bf16"]
    ours = ours.numpy().reshape(theirs.shape)
    logit_dev = float(np.abs(ours - theirs).max())
    score_dev = float(np.abs(sigmoid(ours) - sigmoid(theirs)).max())
    f32_t, f32_o = out["f32"]
    print(f"{arch}: port bf16 vs sed_tpu bf16: logits {logit_dev:.3e}, scores "
          f"{score_dev:.3e}; bf16 vs f32 scores: port "
          f"{np.abs(sigmoid(ours) - sigmoid(f32_o.numpy().reshape(f32_t.shape))).max():.3e}, "
          f"sed_tpu {np.abs(sigmoid(theirs) - sigmoid(f32_t)).max():.3e}")
    assert logit_dev < LOGIT_BAND and score_dev < SCORE_BAND


def test_f32_logits_still_match_sed_tpu(pair):
    """The float32 forward through the same layers is unchanged: 1e-5."""
    _, out, _ = pair
    theirs, ours = out["f32"]
    np.testing.assert_allclose(ours.numpy().reshape(theirs.shape), theirs, rtol=0, atol=1e-5)


def test_bf16_keeps_parameters_and_statistics_in_float32(pair):
    arch, out, port = pair
    assert port.dtype == torch.bfloat16
    assert {v.dtype for k, v in port.state_dict().items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
    assert out["bf16"][1].dtype == torch.float32


@pytest.mark.parametrize("bn, shape", [(BatchNorm2d, (2, 3, 5, 4)), (BatchNorm1d, (2, 3, 7))])
def test_batch_norm_normalizes_a_bf16_input_in_float32(bn, shape):
    """flax's ``_normalize``: (x - mean) * rsqrt(var + eps) * scale + bias in
    float32 from the bfloat16 input, returned in bfloat16."""
    layer = bn(3).eval()
    with torch.no_grad():
        layer.running_mean.uniform_(-0.5, 0.5)
        layer.running_var.uniform_(0.5, 2.0)
        layer.weight.uniform_(0.5, 1.5)
        layer.bias.uniform_(-0.3, 0.3)
        x = torch.randn(shape).to(torch.bfloat16)
        got = layer(x)
        want = layer(x.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_models_without_a_dtype_compute_in_the_input_dtype():
    """dtype None keeps float64 models float64 (the CPU's float64 checks)."""
    model = CnnAvgPooling(1, NARROW, generator=torch.Generator().manual_seed(0)).double().eval()
    with torch.no_grad():
        assert model(torch.randn(1, 1, 16, 64, dtype=torch.float64)).dtype == torch.float64


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1", "M5"])
def test_load_model_and_state_builds_the_bf16_tier(arch, tmp_path):
    """``load_model_and_state(bf16=True)``: the bfloat16 forward over the
    checkpoint's float32 weights; scores within the band of float32's."""
    from sed_tpu_torch.configs import SpectrogramConfig

    model = cli.build_model(arch, 1)
    torch.save({"model": model.state_dict()}, tmp_path / "m.pth")
    cfg = WaveformConfig() if arch == "M5" else SpectrogramConfig()
    f32, _ = cli.load_model_and_state(str(tmp_path / "m.pth"), cfg, arch=arch, device="cpu")
    bf16, _ = cli.load_model_and_state(str(tmp_path / "m.pth"), cfg, arch=arch, bf16=True,
                                       device="cpu")
    assert bf16.dtype == torch.bfloat16 and f32.dtype is None
    for k, v in bf16.state_dict().items():
        assert torch.equal(v, f32.state_dict()[k]), k
    x = torch.randn(2, 1, cfg.frame_size) * 0.1 if arch == "M5" else torch.randn(2, 1, 32, 64)
    with torch.no_grad():
        a, b = f32.eval()(x), bf16.eval()(x)
    if arch != "MobileNetV1":
        a, b = torch.sigmoid(a), torch.sigmoid(b)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) < SCORE_BAND

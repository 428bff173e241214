"""The port's M5 (both stems), its framing and the model descriptions
against sed_tpu's (CPU).

Weights come from flax's init with every BatchNorm scale, bias and running
statistic and every conv and dense bias drawn from a seed, carried over by
``models.convert.m5_state_dict``.  Tolerances: the state dict and the
space-to-depth kernel equal bit for bit to ``sed_tpu``'s; each stem's logits
within 1e-5 abs of flax M5 with the same stem, and the two stems within 1e-5
of each other; the device framing equal to ``frame_coverage_labels``'
frames; parameter counts and description strings equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data.events import frame_coverage_labels
from sed_tpu.models import describe as jax_describe
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.models.m5 import s2d_conv1_kernel as jax_s2d_conv1_kernel
from sed_tpu.train.torch_export import m5_to_torch
from sed_tpu_torch.cli.infer import hop_frames
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.models import describe
from sed_tpu_torch.models.cnn import (DEFAULT_CHANNEL_AND_POOL, TRAIN_CHANNEL_AND_POOL,
                                      CnnAvgPooling)
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict, m5_state_dict
from sed_tpu_torch.models.m5 import M5, S2D_BLOCK, s2d_conv1, s2d_conv1_kernel

ATOL = 1e-5
FRAME = 31680


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_variables(flax_model, sample, seed=0):
    """flax init, then every scale, bias and BN statistic drawn from ``seed``."""
    variables = flax_model.init(jax.random.key(seed), sample, train=False)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(draw, variables["params"]),
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]))


@pytest.fixture(scope="module")
def m5_weights():
    return seeded_variables(FlaxM5(classes_num=2, conv1_s2d=False),
                            jnp.zeros((1, FRAME, 1)), seed=7)


def waves(n, length=FRAME, seed=0):
    x = 0.3 * np.random.default_rng(seed).standard_normal((n, length, 1))
    return np.clip(x, -1, 1).astype(np.float32)


def test_state_dict_equals_sed_tpu_export_bit_for_bit(m5_weights):
    params, stats = m5_weights
    ours, theirs = m5_state_dict(params, stats), m5_to_torch(params, stats)
    assert list(ours) == list(theirs)
    assert set(ours) == set(M5(2).state_dict())
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        assert torch.equal(ours[key], theirs[key]), key


@pytest.mark.parametrize("s2d", [False, True])
def test_stem_matches_flax_with_the_same_stem(m5_weights, s2d):
    params, stats = m5_weights
    x = waves(3, seed=1)
    want = np.asarray(FlaxM5(classes_num=2, conv1_s2d=s2d).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    port = M5(2, conv1_s2d=s2d)
    port.load_state_dict(m5_state_dict(params, stats), strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))))
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_both_stems_load_one_state_dict_and_agree(m5_weights):
    sd = m5_state_dict(*m5_weights)
    direct, s2d = M5(2), M5(2, conv1_s2d=True)
    direct.load_state_dict(sd, strict=True)
    s2d.load_state_dict(sd, strict=True)
    x = torch.from_numpy(waves(4, seed=2).transpose(0, 2, 1).copy())
    with torch.inference_mode():
        a, b = torch.sigmoid(direct.eval()(x)), torch.sigmoid(s2d.eval()(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)
    assert not direct.conv1_s2d and s2d.conv1_s2d


@pytest.mark.parametrize("K,stride,pad,block", [(79, 4, 39, 16), (79, 4, 39, 32),
                                                (5, 2, 2, 8), (3, 1, 1, 4)])
def test_s2d_kernel_equals_sed_tpu_bit_for_bit(K, stride, pad, block):
    w = np.random.default_rng(K + block).standard_normal((K, 1, 6)).astype(np.float32)
    want = np.asarray(jax_s2d_conv1_kernel(jnp.asarray(w), stride=stride, pad=pad,
                                           block=block))
    got = s2d_conv1_kernel(torch.from_numpy(w.transpose(2, 1, 0).copy()), stride=stride,
                           pad=pad, block=block)
    np.testing.assert_array_equal(got.permute(2, 1, 0).numpy(), want)


@pytest.mark.parametrize("n", [FRAME, 1000, 1001, 997, 80])
def test_s2d_conv1_equals_the_direct_conv(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 1, n)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 1, 79)).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    want = F.conv1d(x, w, b, stride=4, padding=39)
    got = s2d_conv1(x, w, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    assert S2D_BLOCK == 16


def test_count_parameters_of_m5_is_426369():
    assert describe.count_parameters(M5(1)) == 426369


def test_describe_m5_equals_sed_tpu():
    params, _ = seeded_variables(FlaxM5(classes_num=1), jnp.zeros((1, FRAME, 1)))
    assert describe.describe_m5(M5(1)) == jax_describe.describe_m5(params)


@pytest.mark.parametrize("config", [TRAIN_CHANNEL_AND_POOL, DEFAULT_CHANNEL_AND_POOL])
@pytest.mark.parametrize("sr", [48000, 8000])
def test_describe_cnn_equals_sed_tpu(config, sr):
    flax_model = FlaxCnnAvgPooling(classes_num=2, model_config=config)
    params, stats = seeded_variables(flax_model, jnp.zeros((1, 32, 64, 1)))
    port = CnnAvgPooling(2, config)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    jcfg = JaxSpectrogramConfig(working_sample_rate=sr)
    cfg = SpectrogramConfig(working_sample_rate=sr)
    assert describe.count_parameters(port) == jax_describe.count_parameters(params)
    assert describe.describe_cnn(port, cfg) == jax_describe.describe_cnn(flax_model, params, jcfg)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("samples", [FRAME - 1, FRAME, FRAME + 15839, FRAME + 15840,
                                     5 * FRAME + 123])
def test_device_framing_equals_frame_coverage_labels(channels, samples):
    wav = np.random.default_rng(samples).standard_normal((samples, channels)).astype(np.float32)
    want, _ = frame_coverage_labels(wav.T, [], [], JaxWaveformConfig())
    got = hop_frames(torch.from_numpy(wav), WaveformConfig())
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)

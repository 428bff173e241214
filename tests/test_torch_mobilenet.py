"""The port's MobileNetV1 against sed_tpu's (CPU).

Weights come from flax's init with every BatchNorm scale, bias and running
statistic and every dense bias drawn from a seed, carried over by
``models.convert.mobilenet_state_dict``.  Tolerances: the state dict equal
bit for bit to ``sed_tpu.train.torch_export.mobilenet_to_torch``'s; the
forward (both ``emit`` values) and the batch predictor within 1e-5 abs of
``sed_tpu``'s on the same numpy input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.inference import make_batch_predictor as jax_make_batch_predictor
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.cnn import mobilenet_receptive_field as jax_mobilenet_rf
from sed_tpu.train.torch_export import mobilenet_to_torch
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import emits_scores, make_batch_predictor
from sed_tpu_torch.models.cnn import MOBILENET_STACK, MobileNetV1, mobilenet_receptive_field
from sed_tpu_torch.models.convert import mobilenet_state_dict

SMALL = dict(working_sample_rate=8000, time_margin=0.33)
ATOL = 1e-5


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

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return params, stats


def mobilenet_pair(emit="scores", seed=0):
    flax_model = FlaxMobileNetV1(classes_num=2, emit=emit)
    params, stats = seeded_variables(flax_model, jnp.zeros((1, 32, 64, 1)), seed)
    port = MobileNetV1(2, emit=emit)
    port.load_state_dict(mobilenet_state_dict(params, stats), strict=True)
    return flax_model, params, stats, port.eval()


def test_state_dict_equals_sed_tpu_export_bit_for_bit():
    _, params, stats, port = mobilenet_pair()
    ours = mobilenet_state_dict(params, stats)
    theirs = mobilenet_to_torch(params, stats)
    assert list(ours) == list(theirs)
    assert set(ours) == set(port.state_dict())
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype, key
        assert torch.equal(ours[key], theirs[key]), key


def test_fresh_model_keys_are_the_reference_keys():
    keys = set(MobileNetV1(1).state_dict())
    assert {"bn0.weight", "bn0.running_var", "fc1.weight", "fc_audioset.bias",
            "features.0.0.weight", "features.0.2.running_mean",
            "features.12.4.weight", "features.12.5.num_batches_tracked"} <= keys
    assert not any(k.startswith(("features.0.4", "features.0.5")) for k in keys)
    assert len(MOBILENET_STACK) == 13


@pytest.mark.parametrize("emit", ["scores", "logits"])
@pytest.mark.parametrize("frames", [64, 61])   # 61: every pool floors
def test_forward_matches_flax(emit, frames):
    flax_model, params, stats, port = mobilenet_pair(emit, seed=1)
    x = np.random.default_rng(2).standard_normal((2, frames, 64, 1)).astype(np.float32)
    want = np.asarray(flax_model.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    assert got.shape == want.shape == (2, 8 * (frames // 8), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if emit == "scores":
        assert ((got >= 0) & (got <= 1)).all()


def test_receptive_field_is_162_and_matches_sed_tpu():
    assert mobilenet_receptive_field() == jax_mobilenet_rf() == 162


def test_batch_predictor_applies_no_second_sigmoid():
    flax_model, params, stats, port = mobilenet_pair(seed=3)
    assert emits_scores(port) and not emits_scores(MobileNetV1(1, emit="logits"))
    x = 0.3 * np.random.default_rng(4).standard_normal((2, 80000, 1))
    x = np.clip(x, -1, 1).astype(np.float32)
    want = np.asarray(jax_make_batch_predictor(flax_model, JaxSpectrogramConfig(**SMALL))(
        params, stats, jnp.asarray(x)))
    got = make_batch_predictor(port, SpectrogramConfig(**SMALL), device="cpu")(x).numpy()
    assert got.shape == want.shape == (2, 24, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # A second sigmoid would squeeze every score into [0.5, 0.731].
    assert float(got.min()) < 0.5 or float(got.max()) > 0.731


def test_unknown_emit_is_refused():
    with pytest.raises(ValueError, match="emit"):
        MobileNetV1(1, emit="probabilities")

"""sed_tpu_torch CnnAvgPooling against sed_tpu's flax module, on the CPU.

Flax weights go through ``sed_tpu_torch.models.convert`` into the port's
module with ``strict=True``; logits must agree to <= 1e-5 abs (float32
convolutions summed in another order).  The state-dict keys must equal those
``sed_tpu.train.torch_export`` emits for the reference checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.models import cnn as jax_cnn
from sed_tpu.train.torch_export import cnn_avg_pooling_to_torch
from sed_tpu_torch.models import cnn
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.models.layers import interpolate

CONFIGS = [
    pytest.param("DEFAULT_CHANNEL_AND_POOL", id="default"),
    pytest.param("TRAIN_CHANNEL_AND_POOL", id="train"),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_variables(model_config, shape_nhwc, seed=0):
    """Flax init from jax.random.key(0), with BatchNorm statistics and
    affine terms replaced by numpy draws so every BN key is exercised."""
    model = jax_cnn.CnnAvgPooling(classes_num=3, model_config=model_config)
    variables = model.init(jax.random.key(0), jnp.zeros(shape_nhwc), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(seed)
    for name, blk in params.items():
        if not name.startswith("ConvBlock_"):
            continue
        for j in range(2):
            bn, st = blk[f"BatchNorm_{j}"], stats[name][f"BatchNorm_{j}"]
            c = bn["scale"].shape
            bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            bn["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            st["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    params["Dense_0"]["bias"] = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    return model, params, stats


@pytest.mark.parametrize("config_name", CONFIGS)
def test_converted_weights_reproduce_flax_logits(config_name):
    model_config = getattr(jax_cnn, config_name)
    assert getattr(cnn, config_name) == model_config
    x = np.random.default_rng(1).standard_normal((2, 1, 32, 64)).astype(np.float32)
    flax_model, params, stats = flax_variables(model_config, (2, 32, 64, 1))
    want = np.asarray(flax_model.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       train=False))
    model = cnn.CnnAvgPooling(3, model_config)
    model.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_state_dict_keys_equal_reference_export(config_name):
    model_config = getattr(jax_cnn, config_name)
    _, params, stats = flax_variables(model_config, (1, 8, 64, 1))
    ours = cnn_avg_pooling_state_dict(params, stats)
    ref = cnn_avg_pooling_to_torch(params, stats)
    assert list(ours) == list(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        torch.testing.assert_close(ours[key], ref[key], rtol=0, atol=0)
    module_keys = set(cnn.CnnAvgPooling(3, model_config).state_dict())
    assert module_keys == set(ref)


def test_num_pools_and_interpolate():
    for name in ("DEFAULT_CHANNEL_AND_POOL", "TRAIN_CHANNEL_AND_POOL"):
        config = getattr(jax_cnn, name)
        assert cnn.num_pools(config) == jax_cnn.num_pools(config) == 3
    quirk = ((8, 1), (16, 2))   # first stage pools by 1: the counter still starts at 1
    assert cnn.num_pools(quirk) == jax_cnn.num_pools(quirk) == 2
    x = torch.arange(6.0).reshape(1, 3, 2)
    np.testing.assert_array_equal(interpolate(x, 4).numpy(),
                                  np.repeat(x.numpy(), 4, axis=1))
    assert interpolate(x, 1) is x


def test_odd_sizes_floor_like_flax_and_output_frame_count():
    """182 frames (60 s) -> 91 -> 45 -> 22 -> x8 = 176, as in sed_tpu."""
    config = ((4, 2), (4, 2), (4, 2), (4, 1))
    flax_model, params, stats = flax_variables(config, (1, 182, 63, 1))
    x = np.random.default_rng(2).standard_normal((1, 1, 182, 63)).astype(np.float32)
    want = np.asarray(flax_model.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(x.transpose(0, 2, 3, 1))))
    model = cnn.CnnAvgPooling(3, config)
    model.load_state_dict(cnn_avg_pooling_state_dict(params, stats))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 176, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_init_is_seeded_and_follows_kaiming_uniform():
    def make(seed):
        return cnn.CnnAvgPooling(1, cnn.TRAIN_CHANNEL_AND_POOL,
                                 generator=torch.Generator().manual_seed(seed))

    state = torch.random.get_rng_state()
    a, b, c = make(0), make(0), make(1)
    assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched
    b_state = b.state_dict()
    for key, value in a.state_dict().items():
        assert torch.equal(value, b_state[key]), key
    w = a.conv_blocks[1].conv1.weight.detach()
    bound = np.sqrt(6.0 / (32 * 9))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert not torch.equal(w, c.conv_blocks[1].conv1.weight)
    bn = a.conv_blocks[0].bn1
    assert torch.equal(bn.running_var, torch.ones(32))
    assert torch.equal(bn.running_mean, torch.zeros(32))
    assert torch.equal(a.event_fc.bias, torch.zeros(1))

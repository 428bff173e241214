"""The port's exact windowed forwards against sed_tpu's (CPU).

``windowed_forward`` and ``bucketed_forward_exact`` of
``sed_tpu_torch.parallel.time_shard`` run the port's CnnAvgPooling on NCHW
input; ``sed_tpu``'s run flax CnnAvgPooling on the same weights (carried by
``models.convert``) and the same numpy input in NHWC.  Tolerances:

  * against ``sed_tpu``'s windowed result: 1e-5 abs (logits);
  * against the port's own whole-recording forward: 1e-5 abs (float32
    summation order only);
  * the output frame count equals the whole forward's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.parallel import time_shard as jax_ts
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.parallel import time_shard

# Narrow widths, TRAIN_CHANNEL_AND_POOL's pools: receptive field 61, stride 8.
NARROW = ((8, 2), (16, 2), (16, 2), (16, 1))
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_stats(model, seed):
    """Non-trivial BN running statistics, so that the pad junctions matter."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
    return model


def pair(model_config, seed=0):
    """flax forward (NHWC, jitted) and the port's model on the same weights."""
    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=model_config)
    variables = flax_model.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 1)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1, variables["batch_stats"])
    port = CnnAvgPooling(1, model_config)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    fwd = jax.jit(lambda b: flax_model.apply({"params": params, "batch_stats": stats}, b,
                                             train=False))
    return fwd, port.eval()


def inputs(t, seed):
    x = np.random.default_rng(seed).standard_normal((1, t, 64, 1)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def check_windowed(t, window, halo, seed=0, model_config=NARROW):
    fwd, port = pair(model_config, seed)
    x_np, x = inputs(t, seed + 1)
    want = jax_ts.windowed_forward(fwd, jnp.asarray(x_np), window=window, halo=halo)
    with torch.inference_mode():
        got = time_shard.windowed_forward(port, x, window=window, halo=halo)
        whole = port(x)
    assert isinstance(got, torch.Tensor)
    assert got.shape == whole.shape == want.shape, (t, window, halo)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL,
                               err_msg=f"{(t, window, halo)}")
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=ATOL,
                               err_msg=f"{(t, window, halo)}")


@pytest.mark.parametrize("t", [40, 100, 128])
def test_short_inputs_run_the_whole_forward(t):
    check_windowed(t, window=64, halo=32)


@pytest.mark.parametrize("t", [1000, 997])   # stride-aligned and ragged lengths
def test_windowed_forward_matches_sed_tpu(t):
    check_windowed(t, window=256, halo=64, model_config=TRAIN_CHANNEL_AND_POOL)


@pytest.mark.parametrize("t,window,halo", [
    (513, 128, 32),    # one frame past a window edge
    (519, 128, 32),    # ragged tail of 7
    (640, 128, 64),    # the last uniform window ends at the recording's end
    (300, 64, 96),     # halo wider than the window
])
def test_windowed_forward_edge_geometries(t, window, halo):
    check_windowed(t, window, halo, seed=2)


@pytest.mark.parametrize("seed", range(6))
def test_windowed_forward_fuzz(seed):
    rng = np.random.default_rng(300 + seed)
    t = int(rng.integers(200, 1200))
    window = 8 * int(rng.integers(8, 48))
    halo = 8 * int(rng.integers(4, 12))  # >= 32 >= rf // 2 == 30
    check_windowed(t, window, halo, seed=seed)


def test_windowed_forward_stays_on_the_device_of_its_input():
    _, port = pair(NARROW)
    _, x = inputs(700, 3)
    seen = []

    def forward(batch):
        seen.append(batch.shape)
        return port(batch)

    with torch.inference_mode():
        out = time_shard.windowed_forward(forward, x, window=128, halo=32)
    assert out.device == x.device and out.shape == (1, 696, 1)
    # One batched pass over the uniform windows, then the ragged tail.
    assert len(seen) == 2 and seen[0][0] == 6 and seen[0][2] == 192


@pytest.mark.parametrize("t", [50, 79, 80, 256, 300, 333])
def test_bucketed_forward_exact_matches_sed_tpu(t):
    fwd, port = pair(NARROW, seed=4)
    x_np, x = inputs(t, 5)
    want = jax_ts.bucketed_forward_exact(fwd, jnp.asarray(x_np), stride=8, halo=32,
                                         bucket=64)
    with torch.inference_mode():
        got = time_shard.bucketed_forward_exact(port, x, stride=8, halo=32, bucket=64)
        whole = port(x)
    assert got.shape == whole.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("config", [NARROW, TRAIN_CHANNEL_AND_POOL,
                                    ((64, 2), (128, 2), (256, 2), (512, 1)),
                                    ((8, 1), (8, 2))])
def test_pool_product_and_receptive_field_match_sed_tpu(config):
    assert time_shard.pool_product(config) == jax_ts.pool_product(config)
    assert time_shard.receptive_field(config) == jax_ts.receptive_field(config)


def test_mobilenet_windowed_equals_whole_forward_at_the_halo_floor():
    """MobileNetV1's receptive field is 162 frames: at halo 88 (the floor)
    the windows reproduce the whole forward."""
    model = seeded_stats(MobileNetV1(1, generator=torch.Generator().manual_seed(0)), 1)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 1, 530, 16))
                         .astype(np.float32))
    with torch.inference_mode():
        got = time_shard.windowed_forward(model.eval(), x, window=64, halo=88)
        whole = model(x)
    assert got.shape == whole.shape == (1, 528, 1)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=ATOL)

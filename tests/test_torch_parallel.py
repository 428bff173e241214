"""The port's data parallelism (``sed_tpu_torch.parallel``) at world size 2
on gloo, against its own single-device path and against ``sed_tpu`` on
``create_mesh(2)`` of the 8-virtual-device CPU platform.

One group of two CPU ranks is spawned for the whole module
(``multihost.launch``); each rank runs every case of
``tests/torch_parallel_worker.py`` and saves its results, and the same cases
run here on one device.  Tolerances are ``tests/test_parallel.py``'s for
``sed_tpu``'s mesh: the loss within rtol 1e-5, parameters within atol 1e-5,
BatchNorm statistics within rtol 1e-5 / atol 1e-6 (one step at lr 1e-3 from
``sed_tpu``'s init), M5 gradients within rtol 1e-3 / atol 5e-6; sharded
scores and pool ticks within 1e-6 of unsharded ones, and the port's scores
within 1e-5 of ``sed_tpu``'s (float32's budget between the packages).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import torch_parallel_worker as worker
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data import device_pipeline as jax_pipe
from sed_tpu.device_streaming import resolve_tick_featurizer as jax_resolve
from sed_tpu.inference import make_batch_predictor as jax_predictor
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.parallel import mesh as jax_mesh
from sed_tpu.parallel.data_parallel import shard_train_step as jax_shard_train_step
from sed_tpu.stream_pool import StreamPool as JaxStreamPool
from sed_tpu.train.loss import weighted_bce_with_logits as jax_bce
from sed_tpu.train.optim import make_optimizer as jax_optimizer
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.device_streaming import DeviceStreamingDetector, resolve_tick_featurizer
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict, m5_state_dict
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.parallel import mesh as port_mesh
from sed_tpu_torch.parallel import multihost
from sed_tpu_torch.stream_pool import StreamPool
from sed_tpu_torch.train import loop
from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool

JCFG = JaxSpectrogramConfig()
J8 = JaxSpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
JW = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33)
SR = 8000
LOSS_RTOL, PARAM_ATOL, BN_RTOL, BN_ATOL = 1e-5, 1e-5, 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 5e-6
SHARD_TOL, SED_TPU_TOL = 1e-6, 1e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _spectrogram_inputs():
    """tests/test_parallel.py's buffers, starts and model, with sed_tpu's
    single-device step and its step on create_mesh(2)."""
    rng = np.random.default_rng(0)
    crop, mel = JCFG.train_crop_size, JCFG.mel_bins
    total = 6 * crop
    features = rng.standard_normal((1, total, mel)).astype(np.float32)
    events = (rng.random((total, 1)) > 0.8).astype(np.float32)
    buffers = jax_pipe.SpectrogramBuffers(
        features=jnp.asarray(features), events=jnp.asarray(events),
        start_indices=jnp.arange(total - crop, dtype=jnp.int32),
        mean=jnp.zeros((mel,), jnp.float32), std=jnp.ones((mel,), jnp.float32))
    starts = np.random.default_rng(1).integers(0, total - crop, size=16, dtype=np.int32)
    blocks = np.random.default_rng(2).integers(0, total - crop, size=(2, 2, 16))
    model = FlaxCnnAvgPooling(classes_num=1, model_config=worker.SMALL)
    tx = jax_optimizer(1e-3)
    sample = jnp.zeros((16, crop, mel, 1), jnp.float32)
    state0 = jax_init_state(model, jax.random.key(0), sample, tx)
    sd = cnn_avg_pooling_state_dict(np_tree(state0.params), np_tree(state0.batch_stats))
    theirs = {}
    step = jax_pipe.make_spectrogram_train_step(model, tx, JCFG, 5.0, "logMel", False)
    s1, loss1 = step(jax_init_state(model, jax.random.key(0), sample, tx), buffers,
                     jnp.asarray(starts), jax.random.key(2))
    mesh = jax_mesh.create_mesh(2)
    raw = jax_pipe.make_spectrogram_train_step(model, tx, JCFG, 5.0, "logMel", False,
                                               jit=False)
    s2, loss2 = jax_shard_train_step(raw, mesh)(
        jax_mesh.replicate(mesh, jax_init_state(model, jax.random.key(0), sample, tx)),
        jax_mesh.replicate(mesh, buffers), jax_mesh.shard_batch(mesh, jnp.asarray(starts)),
        jax_mesh.replicate(mesh, jax.random.key(2)))
    for tag, s, loss in (("single", s1, loss1), ("mesh", s2, loss2)):
        theirs[f"cnn_{tag}_loss"] = float(loss)
        theirs[f"cnn_{tag}_state"] = {k: v.numpy() for k, v in cnn_avg_pooling_state_dict(
            np_tree(s.params), np_tree(s.batch_stats)).items()}
    inputs = {"features": features, "events": events, "starts": starts, "blocks": blocks,
              "state_dict": {k: v.numpy() for k, v in sd.items()}}
    return inputs, theirs


def _m5_inputs():
    """tests/test_parallel.py's M5 case: the loss and gradients of one batch
    of 8 on one device and sharded over create_mesh(2)."""
    rng = np.random.default_rng(0)
    total = 6 * JW.frame_size
    waveform = rng.standard_normal((1, total)).astype(np.float32)
    labels = (rng.random(total) > 0.8).astype(np.float32)
    model = FlaxM5(classes_num=1)
    variables = model.init(jax.random.key(0), jnp.zeros((8, JW.frame_size, 1)), train=False)
    starts = rng.integers(0, total - JW.frame_size, size=8, dtype=np.int32)

    def loss_of(params, starts):
        def one(s):
            return jax.lax.dynamic_slice(jnp.asarray(waveform), (0, s),
                                         (1, JW.frame_size)), jnp.asarray(labels)[s]

        waves, lab = jax.vmap(one)(starts)
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.transpose(waves, (0, 2, 1)), train=True,
                             mutable=["batch_stats"])
        return jax_bce(out, lab, 5.0, multi_frame=False)

    from jax.sharding import NamedSharding, PartitionSpec as P

    grad_fn = jax.value_and_grad(loss_of)
    mesh = jax_mesh.create_mesh(2)
    sharded = jax.jit(grad_fn, in_shardings=(NamedSharding(mesh, P()),
                                             NamedSharding(mesh, P("data"))),
                      out_shardings=(NamedSharding(mesh, P()),) * 2)
    theirs = {}
    for tag, (loss, grads) in (("single", jax.jit(grad_fn)(variables["params"], starts)),
                               ("mesh", sharded(jax_mesh.replicate(mesh, variables["params"]),
                                                jax_mesh.shard_batch(mesh, starts)))):
        theirs[f"m5_{tag}_loss"] = float(loss)
        theirs[f"m5_{tag}_grads"] = {
            k: v.numpy() for k, v in m5_state_dict(np_tree(grads),
                                                   np_tree(variables["batch_stats"])).items()}
    sd = m5_state_dict(np_tree(variables["params"]), np_tree(variables["batch_stats"]))
    # A second M5 with seeded BatchNorm statistics for the pool.
    seeded = M5(1, generator=torch.Generator().manual_seed(4))
    seeded_sd = {k: v.numpy().copy() for k, v in seeded.state_dict().items()}
    g = np.random.default_rng(5)
    for k in seeded_sd:
        if k.endswith("running_mean"):
            seeded_sd[k] = g.uniform(-0.05, 0.05, seeded_sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            seeded_sd[k] = g.uniform(0.5, 2.0, seeded_sd[k].shape).astype(np.float32)
    streams = [(0.1 * g.standard_normal(4 * SR + 4321)).astype(np.float32),
               (3000 * g.standard_normal(3 * SR + 999)).astype(np.int16)]
    inputs = {"waveform": waveform, "labels": labels, "starts": starts,
              "state_dict": {k: v.numpy() for k, v in sd.items()}, "seeded": seeded_sd,
              "streams": streams}
    return inputs, theirs


def _predict_inputs(root):
    """Seeded weights for the scoring cases (the small CnnAvgPooling for the
    batch, TRAIN_CHANNEL_AND_POOL for the pools), 4 int16 clips, features,
    3 WAVs (two of one length), the pools' streams, and sed_tpu's sharded
    predictor on the clips."""
    flax_small = FlaxCnnAvgPooling(classes_num=1, model_config=worker.SMALL)
    v = flax_small.init(jax.random.key(3), jnp.zeros((1, 30, 64, 1)), train=False)
    params, stats = np_tree(v["params"]), np_tree(v["batch_stats"])
    rng = np.random.default_rng(7)
    pcm = (3000 * rng.standard_normal((4, 3 * SR, 1))).astype(np.int16)
    mean = rng.uniform(-60, -40, 64).astype(np.float32)
    std = rng.uniform(5, 15, 64).astype(np.float32)
    mesh = jax_mesh.create_mesh(2)
    theirs = {"predict": np.asarray(jax_predictor(flax_small, J8, mesh, mean, std)(
        jax_mesh.replicate(mesh, params), jax_mesh.replicate(mesh, stats),
        jax_mesh.shard_batch(mesh, jnp.asarray(pcm.astype(np.float32) / 32768.0))))}
    files = []
    for i, n in enumerate((3 * SR + 17, 3 * SR + 17, 2 * SR + 5)):
        path = root / f"clip{i}.wav"
        wavfile.write(path, SR, (3000 * rng.standard_normal(n)).astype(np.int16))
        files.append(str(path))
    pool_model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                               generator=torch.Generator().manual_seed(6))
    inputs = {
        "state_dict": {k: t.numpy() for k, t in cnn_avg_pooling_state_dict(params, stats).items()},
        "pcm": pcm, "mean": mean, "std": std, "files": files,
        "features": rng.standard_normal((4, 1, 30, 64)).astype(np.float32),
        "targets": (rng.random((4, 8, 1)) > 0.6).astype(np.float32),
    }
    pool = {
        "state_dict": {k: t.numpy().copy() for k, t in pool_model.state_dict().items()},
        "streams": [(2000 * rng.standard_normal(n)).astype(np.int16)
                    for n in (5 * SR + 300, 3 * SR + 4100, 7 * SR + 11, 2 * SR + 2500)],
        "lockstep": [(0.1 * rng.standard_normal((2, SR))).astype(np.float32)
                     for _ in range(6)],
    }
    return inputs, pool, theirs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, sed_tpu's results, the port on one device, the port's two
    ranks)."""
    root = tmp_path_factory.mktemp("parallel")
    cnn, theirs = _spectrogram_inputs()
    m5, theirs_m5 = _m5_inputs()
    predict, pool, theirs_p = _predict_inputs(root)
    theirs.update(theirs_m5)
    theirs.update(theirs_p)
    inputs = {"cnn": cnn, "m5": m5, "predict": predict, "pool": pool}
    torch.save(inputs, root / "inputs.pt")
    env_before = os.environ.get("TORCH_FR_BUFFER_SIZE")
    multihost.launch(worker.rank_main, 2, "cpu", args=(str(root),))
    inputs["fr_buffer_size"] = (env_before, os.environ.get("TORCH_FR_BUFFER_SIZE"))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = worker.run_cases(inputs, None)
    finally:
        torch.set_num_threads(n)
    return inputs, theirs, single, ranks


def assert_state_close(got, want, what):
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if "running_" in key:
            np.testing.assert_allclose(got[key], value, rtol=BN_RTOL, atol=BN_ATOL,
                                       err_msg=f"{what}: {key}")
        else:
            np.testing.assert_allclose(got[key], value, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {key}")


def test_train_step_on_two_ranks_matches_one_device_and_sed_tpu(runs):
    _, theirs, single, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["cnn_loss"], single["cnn_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["cnn_loss"], theirs["cnn_mesh_loss"], rtol=LOSS_RTOL)
        assert_state_close(got["cnn_state"], single["cnn_state"], f"rank {r} vs one device")
        assert_state_close(got["cnn_state"], theirs["cnn_mesh_state"],
                           f"rank {r} vs sed_tpu's mesh")
    np.testing.assert_allclose(theirs["cnn_mesh_loss"], theirs["cnn_single_loss"],
                               rtol=LOSS_RTOL)


def test_batch_norm_statistics_are_the_global_batch_s(runs):
    """Every running mean and (biased) variance after the mesh step equals
    the single-device step's over the whole batch, on both ranks alike, and
    differs from what one rank's half of the batch alone would give."""
    inputs, theirs, single, ranks = runs
    keys = [k for k in single["cnn_state"] if "running_" in k]
    assert len(keys) == 8
    for k in keys:
        np.testing.assert_array_equal(ranks[0]["cnn_state"][k], ranks[1]["cnn_state"][k])
        np.testing.assert_allclose(ranks[0]["cnn_state"][k], theirs["cnn_single_state"][k],
                                   rtol=BN_RTOL, atol=BN_ATOL)
    # One rank's half of the batch on one device: other statistics.
    local = _half_batch_state(inputs)
    k = "conv_blocks.0.bn1.running_var"
    assert np.abs(local[k] - ranks[0]["cnn_state"][k]).max() > 1e-4


def _half_batch_state(inputs):
    from sed_tpu_torch.data import device_pipeline as pipe

    inp = inputs["cnn"]
    state = worker._state(CnnAvgPooling(1, worker.SMALL), inp["state_dict"], "cpu")
    pipe.make_spectrogram_train_step(worker.TRAIN_CFG, 5.0, "logMel", False)(
        state, worker.spectrogram_buffers(inp, "cpu"), inp["starts"][:8])
    return worker._np(state.model.state_dict())


def test_steps_per_call_with_augmentation_on_two_ranks_matches_one_device(runs):
    """mesh x steps_per_call=2, augmentation drawn for the global batch:
    four steps in two calls equal the single-device calls."""
    _, _, single, ranks = runs
    for r, got in enumerate(ranks):
        assert got["multi_losses"].shape == (4,)
        np.testing.assert_allclose(got["multi_losses"], single["multi_losses"],
                                   rtol=LOSS_RTOL)
        assert_state_close(got["multi_state"], single["multi_state"], f"rank {r}")


def test_m5_step_on_two_ranks_matches_one_device_and_sed_tpu(runs):
    _, theirs, single, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["m5_loss"], single["m5_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["m5_loss"], theirs["m5_mesh_loss"], rtol=LOSS_RTOL)
        for k, g in got["m5_grads"].items():
            np.testing.assert_allclose(g, single["m5_grads"][k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"rank {r}: {k}")
            np.testing.assert_allclose(g, theirs["m5_mesh_grads"][k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"rank {r} vs sed_tpu: {k}")
        for k in got["m5_state"]:
            if "running_" in k:
                np.testing.assert_allclose(got["m5_state"][k], single["m5_state"][k],
                                           rtol=BN_RTOL, atol=BN_ATOL, err_msg=k)


def test_sharded_scoring_matches_unsharded_and_sed_tpu(runs):
    """shard_inference and make_batch_predictor(mesh=): every rank returns
    the global batch's scores."""
    _, theirs, single, ranks = runs
    for got in ranks:
        for key in ("predict", "shard_inference"):
            assert got[key].shape == single[key].shape
            np.testing.assert_allclose(got[key], single[key], rtol=0, atol=SHARD_TOL)
        np.testing.assert_allclose(got["predict"], theirs["predict"], rtol=0, atol=SED_TPU_TOL)


def test_sharded_batch_evaluator_matches_unsharded(runs):
    """make_batch_evaluator(mesh=): every rank returns the scores, losses,
    recalls, precisions and APs of the whole batch."""
    _, _, single, ranks = runs
    for got in ranks:
        assert len(got["evaluate"]) == len(single["evaluate"]) == 5
        for a, b in zip(got["evaluate"], single["evaluate"]):
            assert a.shape == b.shape and a.shape[0] == 4
            np.testing.assert_allclose(a, b, rtol=0, atol=SHARD_TOL)


def test_batch_predict_files_with_an_odd_file_count(runs):
    """Three files in groups of 2 and 1, each padded to the mesh size; the
    padding rows are dropped."""
    _, _, single, ranks = runs
    for got in ranks:
        assert len(got["files"]) == 3
        for a, b in zip(got["files"], single["files"]):
            assert a.shape == b.shape and a.shape[0] > 0
            np.testing.assert_allclose(a, b, rtol=0, atol=SHARD_TOL)


def test_stream_pool_with_slots_sharded(runs):
    """A 4-slot StreamPool over two ranks (late join, uneven pieces,
    leave_many) returns every stream's scores as the one-process pool, with
    the tick's featurizer 'auto' (K3 + K2 on each rank) and 'xla'."""
    inputs, _, single, ranks = runs
    for got in ranks:
        for key in ("pool", "pool_xla"):
            for i, (a, b) in enumerate(zip(got[key], single[key])):
                assert a.shape == b.shape and a.shape[0] > 0, (key, i)
                np.testing.assert_allclose(a, b, rtol=0, atol=SHARD_TOL,
                                           err_msg=f"{key} stream {i}")


def test_device_streaming_detector_with_its_batch_sharded(runs):
    _, _, single, ranks = runs
    for got in ranks:
        assert got["lockstep"].shape == single["lockstep"].shape
        np.testing.assert_allclose(got["lockstep"], single["lockstep"], rtol=0, atol=SHARD_TOL)


def test_device_waveform_pool_with_slots_sharded(runs):
    """Two slots over two ranks, one of them with a backlog of several
    rounds (single-round calls under a mesh)."""
    _, _, single, ranks = runs
    for got in ranks:
        for a, b in zip(got["wpool"], single["wpool"]):
            assert a.shape == b.shape and a.shape[0] > 0
            np.testing.assert_allclose(a, b, rtol=0, atol=SHARD_TOL)


def test_resolve_tick_featurizer_follows_sed_tpu_under_a_mesh():
    """'xla' and the refusal of an explicit 'pallas' as ``sed_tpu``'s; 'auto'
    under a mesh stays on the port's kernels, where ``sed_tpu`` falls back
    to 'xla' (quirk Q2)."""
    mesh = port_mesh.Mesh(None, 2, 0, torch.device("cpu"))
    assert resolve_tick_featurizer("xla", worker.SCFG, mesh) == \
        jax_resolve("xla", J8, object()) == "xla"
    assert jax_resolve("auto", J8, object()) == "xla"
    assert resolve_tick_featurizer("auto", worker.SCFG, mesh) == "pallas"
    assert resolve_tick_featurizer("auto", worker.SCFG) == "pallas"
    messages = []
    for fn, cfg, m in ((resolve_tick_featurizer, worker.SCFG, mesh),
                       (jax_resolve, J8, object())):
        with pytest.raises(ValueError) as exc:
            fn("pallas", cfg, m)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="auto|xla|pallas"):
        resolve_tick_featurizer("bogus", worker.SCFG, mesh)


def test_indivisible_batches_and_slots_are_refused_with_sed_tpu_s_messages(tmp_path):
    mesh = port_mesh.Mesh(None, 2, 0, torch.device("cpu"))
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    with pytest.raises(ValueError) as exc:
        StreamPool(model, worker.SCFG, slots=3, mesh=mesh, device="cpu", **worker.POOL_KW)
    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL)
    v = flax_model.init(jax.random.key(0), jnp.zeros((1, 30, 64, 1)), train=False)
    with pytest.raises(ValueError) as theirs:
        JaxStreamPool(flax_model, v["params"], v["batch_stats"], J8, slots=3,
                      mesh=jax_mesh.create_mesh(2), **worker.POOL_KW)
    assert str(exc.value) == str(theirs.value)
    with pytest.raises(ValueError, match="slots 3 must divide over the 2-device mesh"):
        DeviceWaveformStreamPool(M5(1), worker.WCFG, slots=3, mesh=mesh, device="cpu")
    with pytest.raises(AssertionError, match="batch 3 must divide over the 2-device mesh"):
        DeviceStreamingDetector(model, worker.SCFG, batch=3, mesh=mesh, device="cpu",
                                **worker.POOL_KW)
    with pytest.raises(ValueError, match="global batch_size=5 must be divisible by the "
                                         "mesh size 2"):
        loop.train(model, None, "spectogram", 2, 1e-3, 2, str(tmp_path), batch_size=5,
                   mesh=mesh)
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        port_mesh.create_mesh(2)


def test_one_rank_mesh_and_the_helpers():
    """create_mesh(1) makes its own one-rank gloo group; the sharding
    descriptors, shard_batch, replicate, the multihost puts and the
    collectives at world size 1; shutdown leaves no group."""
    import torch.distributed as dist

    assert multihost.is_primary_host() and not dist.is_initialized()
    multihost.initialize_multihost("localhost:1", 1, 0)     # a no-op
    assert not dist.is_initialized()
    mesh = port_mesh.create_mesh(1, devices=["cpu"])
    try:
        assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
        assert multihost.is_primary_host()
        assert port_mesh.batch_sharding(mesh).spec == ("data",)
        assert port_mesh.replicated_sharding(mesh).spec == ()
        tree = {"a": np.arange(6.0).reshape(3, 2), "b": [torch.ones(2)], "c": 3}
        for put in (port_mesh.shard_batch, port_mesh.replicate, multihost.global_replicate,
                    multihost.global_shard_batch):
            got = put(mesh, tree)
            assert torch.equal(got["a"], torch.arange(6.0, dtype=torch.float64).reshape(3, 2))
            assert torch.equal(got["b"][0], torch.ones(2)) and got["c"] == 3
        t = torch.arange(4.0)
        port_mesh.all_reduce_sum_(mesh, t)
        assert t.tolist() == [0.0, 1.0, 2.0, 3.0]
        g = [torch.full((2,), 3.0), torch.full((1,), 5.0)]
        port_mesh.all_reduce_mean_(mesh, g)
        assert g[0].tolist() == [3.0, 3.0] and g[1].tolist() == [5.0]
        assert torch.equal(port_mesh.gather_rows(mesh, t), t)
        assert port_mesh.row_from_owner(mesh, torch.eye(3), 1).tolist() == [0.0, 1.0, 0.0]
        assert port_mesh.local_rows(mesh, 5) == slice(0, 5)
        with pytest.raises(ValueError, match="create_mesh\\(2\\) on a process group of 1"):
            port_mesh.create_mesh(2)
        from sed_tpu_torch.models.layers import global_batch_norm

        model = CnnAvgPooling(1, worker.SMALL)
        norms = [m for m in model.modules() if hasattr(m, "running_var")]
        with global_batch_norm(model, mesh):
            assert len(norms) == 4 and all(m.mesh is mesh for m in norms)
        with global_batch_norm(model, None):
            assert all(m.mesh is None for m in norms)
        assert all(m.mesh is None for m in norms)
    finally:
        multihost.shutdown_multihost()
    assert not dist.is_initialized()
    assert port_mesh.local_rows(port_mesh.Mesh(None, 4, 2, torch.device("cpu")), 8) == \
        slice(4, 6)
    with pytest.raises(ValueError, match="do not divide"):
        port_mesh.local_rows(port_mesh.Mesh(None, 4, 2, torch.device("cpu")), 6)


@pytest.mark.parametrize("kind", ["2d-f64", "1d-f64", "2d-bf16"])
def test_global_batch_norm_on_one_rank_equals_the_layer_without_a_mesh(kind):
    """The written-out global batch norm on a one-rank mesh against the same
    layer without a mesh: output, input, weight and bias gradients and the
    running statistics (float64: 1e-10; a bf16 input: its output within
    one bf16 ulp, its gradients within 1e-2 of their largest)."""
    from sed_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d, global_batch_norm

    layer, shape = ((BatchNorm1d, (6, 5, 40)) if kind.startswith("1d")
                    else (BatchNorm2d, (6, 5, 7, 8)))
    dtype = torch.float64 if kind.endswith("f64") else torch.bfloat16
    g = torch.Generator().manual_seed(9)
    x0 = torch.randn(shape, generator=g, dtype=torch.float64) * 3 + 2
    gy = torch.randn(shape, generator=g, dtype=torch.float64)
    out = []
    mesh = port_mesh.create_mesh(1, devices=["cpu"])
    try:
        for m in (None, mesh):
            bn = layer(5)
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
                bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
            if dtype == torch.float64:
                bn = bn.double()
            x = x0.to(dtype).requires_grad_()
            with global_batch_norm(bn, m):
                y = bn.train()(x)
            (y.double() * gy).sum().backward()
            out.append([y.double(), x.grad.double(), bn.weight.grad, bn.bias.grad,
                        bn.running_mean, bn.running_var, bn.num_batches_tracked])
    finally:
        multihost.shutdown_multihost()
    for i, (a, b) in enumerate(zip(*out)):
        if dtype == torch.float64 or i >= 4:
            torch.testing.assert_close(b, a, rtol=0, atol=1e-10 if dtype == torch.float64
                                       else 1e-6, msg=str(i))
        elif i == 0:
            assert (b - a).abs().max() <= 2 ** -7 * a.abs().max()
        else:
            assert (b - a).abs().max() <= 1e-2 * a.abs().max(), i



def test_launched_ranks_turn_the_flight_recorder_off_and_leave_the_caller_s(runs):
    """Each rank of ``multihost.launch`` turns NCCL's flight recorder off in
    its own process; the launching process keeps its environment."""
    inputs, _, _, ranks = runs
    before, after = inputs["fr_buffer_size"]
    assert after == before
    for got in ranks:
        assert got["fr_buffer_size"] == (before if before is not None else "0")


def test_nccl_flight_recorder_is_off_unless_the_caller_chose(monkeypatch):
    for name in ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE"):
        monkeypatch.delenv(name, raising=False)
    multihost.nccl_flight_recorder_off()
    assert os.environ["TORCH_FR_BUFFER_SIZE"] == "0"
    for name in ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE"):
        monkeypatch.delenv("TORCH_FR_BUFFER_SIZE", raising=False)
        monkeypatch.setenv(name, "2000")
        multihost.nccl_flight_recorder_off()
        assert os.environ[name] == "2000"
        assert os.environ.get("TORCH_FR_BUFFER_SIZE", "2000") == "2000"
        monkeypatch.delenv(name)

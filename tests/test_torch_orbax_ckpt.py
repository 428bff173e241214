"""The reader of ``sed_tpu``'s orbax checkpoints
(``sed_tpu_torch/train/orbax_ckpt.py``) against ``sed_tpu``'s own saves, on
the CPU.

``read_orbax_checkpoint`` of ``save_checkpoint(..., backend="orbax")``
equals ``read_flax_checkpoint`` of the msgpack save of the same state: the
same keys, dtypes, shapes and values (difference 0), for a full-width
CnnAvgPooling state (its arrays indirect, in the per-process data file), a
narrow M5 state and the committed fixture (``tests/golden/torch_orbax/``,
what the card reads: ``tests/torch_orbax_fixture.py``).  A full resume from
the fixture's orbax directory and from its msgpack twin gives identical
float64 steps.  OCDBT databases with interior B+tree nodes and zarr arrays
of several chunks (edge chunks cropped, missing chunks the fill value) are
written by tensorstore itself.  A flipped byte fails its CRC-32C, naming
the file; a missing libzstd raises.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_orbax_fixture as fixture
from sed_tpu.models.cnn import TRAIN_CHANNEL_AND_POOL
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.train.optim import make_optimizer as jax_make_optimizer
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.models.cnn import CnnAvgPooling
from sed_tpu_torch.train import checkpoint, orbax_ckpt
from sed_tpu_torch.train.flax_ckpt import read_flax_checkpoint
from sed_tpu_torch.train.state import init_state

CFG = SpectrogramConfig()
FIXTURE_ORBAX = str(fixture.GOLDEN / fixture.ORBAX_NAME)
FIXTURE_CKPT = str(fixture.GOLDEN / fixture.CKPT_NAME)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    assert isinstance(got, np.ndarray), path
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def drawn_state(model, sample, seed):
    """``sed_tpu``'s train state of ``model`` with every leaf drawn from a
    seed (floats >= 0; the step and counts 57), its shapes from an abstract
    init (nothing compiled)."""
    shapes = jax.eval_shape(lambda: jax_init_state(model, jax.random.key(0), sample,
                                                   jax_make_optimizer(1e-4)))
    rng = np.random.default_rng(seed)

    def draw(x):
        if np.dtype(x.dtype).kind == "f":
            return np.abs(rng.standard_normal(x.shape)).astype(x.dtype)
        return np.full(x.shape, 57, x.dtype)

    return jax.tree.map(draw, shapes)


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "M5"])
def test_orbax_equals_msgpack_of_the_same_state(arch, tmp_path):
    """Full-width CnnAvgPooling (arrays up to 1.2 MB, stored indirect) and
    M5 (1-D kernels), every leaf drawn from a seed."""
    if arch == "M5":
        model, sample = FlaxM5(classes_num=1), jnp.zeros((2, 31680, 1))
    else:
        model = FlaxCnn(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL)
        sample = jnp.zeros((2, 30, 64, 1))
    state = drawn_state(model, sample, seed=1)
    orbax, ckpt = fixture.write_pair(state, tmp_path, 57)
    got = orbax_ckpt.read_orbax_checkpoint(str(orbax))
    assert_trees_equal(got, read_flax_checkpoint(str(ckpt)))
    assert int(got["step"]) == 57


def test_committed_fixture_equals_its_msgpack_twin():
    got = orbax_ckpt.read_orbax_checkpoint(FIXTURE_ORBAX)
    assert_trees_equal(got, read_flax_checkpoint(FIXTURE_CKPT))
    assert int(got["step"]) == fixture.STEPS
    assert int(got["opt_state"]["0"]["count"]) == fixture.STEPS
    assert np.abs(got["opt_state"]["0"]["mu"]["Dense_0"]["kernel"]).max() > 0
    size = sum(p.stat().st_size for p in fixture.GOLDEN.rglob("*") if p.is_file())
    assert size < 300 * 1024


def float64_steps(path, k=3):
    """A float64 full resume of ``path`` into CnnAvgPooling(1, SMALL), then
    ``k`` steps on seeded crops: (losses, state)."""
    state = checkpoint.load_checkpoint(
        path, init_state(CnnAvgPooling(1, fixture.SMALL).double(), fixture.LR, "cpu", seed=3))
    rng = np.random.default_rng(2)
    crop, mel, total = CFG.train_crop_size, CFG.mel_bins, 4 * CFG.train_crop_size
    bufs = pipe.SpectrogramBuffers(
        features=torch.from_numpy(rng.standard_normal((1, total, mel))),
        events=torch.from_numpy((rng.random((total, 1)) > 0.7).astype(np.float32)),
        start_indices=torch.arange(total - crop), mean=torch.zeros(mel, dtype=torch.float64),
        std=torch.ones(mel, dtype=torch.float64))
    step = pipe.make_spectrogram_train_step(CFG, 5.0, "logMel", False)
    losses = [float(step(state, bufs, rng.integers(0, total - crop, 8))) for _ in range(k)]
    return losses, state


@pytest.mark.parametrize("suffix", ["", "/"], ids=["dir", "dir-slash"])
def test_full_resume_from_orbax_equals_resume_from_msgpack(suffix):
    l_orbax, s_orbax = float64_steps(FIXTURE_ORBAX + suffix)
    l_ckpt, s_ckpt = float64_steps(FIXTURE_CKPT)
    assert s_orbax.step == s_ckpt.step == fixture.STEPS + 3
    assert l_orbax == l_ckpt and np.isfinite(l_orbax).all()
    for (k, v), w in zip(s_orbax.model.state_dict().items(), s_ckpt.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_model_only_and_read_model_weights_take_orbax():
    weights, step = checkpoint.read_model_weights(FIXTURE_ORBAX, "CnnAvgPooling")
    want, want_step = checkpoint.read_model_weights(FIXTURE_CKPT, "CnnAvgPooling")
    assert step == want_step == fixture.STEPS
    for k, v in want.items():
        assert torch.equal(weights[k], v), k
    fresh = init_state(CnnAvgPooling(1, fixture.SMALL), fixture.LR, "cpu", seed=4)
    state = checkpoint.load_checkpoint(FIXTURE_ORBAX, fresh, model_only=True)
    assert state.step == 0 and not state.optimizer.state


def test_exporter_takes_orbax(tmp_path):
    """``cli/export_torch``'s exporter writes the same reference ``.pth``
    from the orbax directory as from its msgpack twin."""
    from sed_tpu_torch.train.torch_export import export_torch_checkpoint

    a = export_torch_checkpoint(FIXTURE_ORBAX, CnnAvgPooling(1, fixture.SMALL),
                                str(tmp_path / "a.pth"), device="cpu")
    b = export_torch_checkpoint(FIXTURE_CKPT, CnnAvgPooling(1, fixture.SMALL),
                                str(tmp_path / "b.pth"), device="cpu")
    pa, pb = torch.load(a, weights_only=True), torch.load(b, weights_only=True)
    assert pa["iterations"] == pb["iterations"] == fixture.STEPS
    for k, v in pb["model"].items():
        assert torch.equal(pa["model"][k], v), k


def copy_fixture(tmp_path):
    dst = tmp_path / fixture.ORBAX_NAME
    shutil.copytree(FIXTURE_ORBAX, dst)
    return dst


def flip_byte(path, offset):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x40
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("which", ["manifest", "node"])
def test_a_flipped_byte_fails_its_crc(tmp_path, which):
    root = copy_fixture(tmp_path)
    if which == "manifest":
        target = root / "manifest.ocdbt"
    else:
        target = next(p for p in (root / "d").iterdir())
    flip_byte(target, 20)
    with pytest.raises(ValueError, match=f"{target.name}.*CRC-32C"):
        orbax_ckpt.read_orbax_checkpoint(str(root))


def test_unknown_layouts_are_refused(tmp_path):
    empty = tmp_path / "iteration_5.ckpt.orbax"
    empty.mkdir()
    with pytest.raises(ValueError, match="not an orbax OCDBT checkpoint"):
        orbax_ckpt.read_orbax_checkpoint(str(empty))
    with pytest.raises(ValueError, match="not an orbax OCDBT checkpoint"):
        checkpoint.read_model_weights(str(empty), "CnnAvgPooling")
    root = copy_fixture(tmp_path)
    (root / "manifest.ocdbt").write_bytes(b"\x00" * 40)
    with pytest.raises(ValueError, match="manifest.ocdbt.*magic"):
        orbax_ckpt.read_orbax_checkpoint(str(root))


def test_missing_libzstd_raises(monkeypatch):
    monkeypatch.setattr(orbax_ckpt, "ZSTD_LIBRARY", "libzstd-absent.so.0")
    monkeypatch.setattr(orbax_ckpt, "_zstd", None)
    with pytest.raises(RuntimeError, match="libzstd-absent"):
        orbax_ckpt.read_orbax_checkpoint(FIXTURE_ORBAX)


def test_crc32c_known_value():
    assert orbax_ckpt.crc32c(b"123456789") == 0xE3069283


def tensorstore_kv(root, **config):
    import tensorstore as ts

    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                            "config": config}).result()


def test_interior_nodes_of_a_tensorstore_database(tmp_path):
    """Interior B+tree nodes (height 3 at 400-byte nodes), front-coded keys,
    inline and indirect values, one version written in a transaction."""
    import tensorstore as ts

    kv = tensorstore_kv(tmp_path, max_decoded_node_bytes=400, max_inline_value_bytes=16)
    want = {f"key/{i:04d}".encode(): bytes([i % 251]) * (i % 40) for i in range(300)}
    txn = ts.Transaction()
    for k, v in want.items():
        kv.with_transaction(txn).write(k, v).result()
    txn.commit_async().result()
    reader = orbax_ckpt.OcdbtReader(str(tmp_path))
    assert reader.root_ref[3] >= 2
    assert reader.items() == want


@pytest.mark.parametrize("dtype", ["<f4", "<i4", "<f8", "bfloat16"])
def test_multi_chunk_zarr_arrays(tmp_path, dtype):
    """A (7, 10, 3) array in (3, 4, 2) chunks (edge chunks cropped), one
    chunk left unwritten (the fill value), zstd, in an OCDBT store."""
    import tensorstore as ts

    rng = np.random.default_rng(0)
    want = (rng.standard_normal((7, 10, 3)) * 100).astype(np.float32 if dtype == "bfloat16"
                                                          else np.dtype(dtype))
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
                   "path": "params.w", "metadata": {
                       "shape": list(want.shape), "chunks": [3, 4, 2], "dtype": dtype,
                       "compressor": {"id": "zstd", "level": 1}, "fill_value": 0,
                       "dimension_separator": "."}},
                  create=True).result()
    if dtype == "bfloat16":
        want = (want.view(np.uint32) & 0xFFFF0000).view(np.float32)
        arr[...] = want.astype(ts.bfloat16.numpy_dtype)
    else:
        arr[...] = want
    arr[3:6, 4:8, 0:2] = 0     # a chunk of fill values, which the store may leave out
    want[3:6, 4:8, 0:2] = 0
    kv = orbax_ckpt.OcdbtReader(str(tmp_path)).items()
    got = orbax_ckpt.read_zarr_array(kv, "params.w", str(tmp_path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)

"""The port's checkpoint reading and converters against sed_tpu's (CPU).

``sed_tpu`` writes a train state with ``flax.serialization.to_bytes``; the
port reads it with its own decoder (``train/flax_ckpt.py``, no flax and no
msgpack package).  Held here against flax's own restore (array for array,
dtype and value), against ``sed_tpu``'s ``load_model_and_state`` forward
(1e-5 on the same numpy input) and against ``sed_tpu``'s exporter (key for
key, bit for bit).  Weights: flax's init with every scale, bias and
BatchNorm statistic drawn from a seed.
"""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from sed_tpu.cli.infer import load_model_and_state as jax_load_model_and_state
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.models import cnn as jax_cnn
from sed_tpu.models.m5 import M5 as JaxM5
from sed_tpu.train import checkpoint as jax_checkpoint
from sed_tpu.train import torch_export as jax_export
from sed_tpu.train.optim import make_optimizer as jax_make_optimizer
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.cli import export_torch as export_cli
from sed_tpu_torch.cli import import_torch as import_cli
from sed_tpu_torch.cli import infer as cli
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.models import cnn
from sed_tpu_torch.train import checkpoint, flax_ckpt, torch_export, torch_import

ARCHS = ("CnnAvgPooling", "MobileNetV1", "M5")
SMALL = ((8, 2), (16, 2))
ATOL = 1e-5
CFG, WCFG = SpectrogramConfig(), WaveformConfig()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_model(arch):
    """(flax module, init sample) of ``arch``; CnnAvgPooling at
    TRAIN_CHANNEL_AND_POOL."""
    if arch == "M5":
        return JaxM5(classes_num=1), jnp.zeros((1, JaxWaveformConfig().frame_size, 1))
    sample = jnp.zeros((1, 30, 64, 1))
    if arch == "MobileNetV1":
        return jax_cnn.MobileNetV1(classes_num=1), sample
    return jax_cnn.CnnAvgPooling(classes_num=1, model_config=jax_cnn.TRAIN_CHANNEL_AND_POOL), sample


def seeded_state(arch, seed=0, step=0):
    """sed_tpu's ``init_state`` of ``arch`` with seeded scales, biases and
    BatchNorm statistics.  The init is eager, as in sed_tpu's loaders and
    exporter, which then find its per-shape initializer compiles cached."""
    model, sample = flax_model(arch)
    state = jax_init_state(model, jax.random.key(seed), sample, jax_make_optimizer(1e-4))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name, a = path[-1].key, np.asarray(a)
        lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3), "mean": (-0.5, 0.5),
                  "var": (0.5, 2.0)}.get(name, (None, None))
        return a if lo is None else rng.uniform(lo, hi, a.shape).astype(np.float32)

    return model, state.replace(
        step=jnp.asarray(step, jnp.int32),
        params=jax.tree_util.tree_map_with_path(draw, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(draw, state.batch_stats))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{arch: (flax module, state, .ckpt path)} at full width, step 123."""
    out = {}
    for i, arch in enumerate(ARCHS):
        model, state = seeded_state(arch, seed=i, step=123)
        root = tmp_path_factory.mktemp(arch)
        out[arch] = (model, state, jax_checkpoint.save_checkpoint(state, str(root), 123))
    return out


@pytest.fixture(scope="module")
def sed_tpu_scores(saved):
    """{arch: (input, sed_tpu's forward on it of the model and weights its
    ``load_model_and_state`` restores)}."""
    out = {}
    for arch, (_, _, ckpt) in saved.items():
        cfg = JaxWaveformConfig() if arch == "M5" else JaxSpectrogramConfig()
        jmodel, jstate = jax_load_model_and_state(ckpt, cfg, arch=arch)
        x = sample_input(arch)
        out[arch] = x, np.asarray(jmodel.apply(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}, x, train=False))
    return out


@pytest.fixture(scope="module")
def sed_tpu_pth(saved, tmp_path_factory):
    """{arch: sed_tpu's export of the saved .ckpt to a reference .pth}."""
    out = {}
    for arch, (model, _, ckpt) in saved.items():
        path = str(tmp_path_factory.mktemp(f"pth_{arch}") / "ref.pth")
        out[arch] = jax_export.export_torch_checkpoint(ckpt, model,
                                                       np.asarray(flax_model(arch)[1]), path)
    return out


def assert_trees_equal(ours, theirs, where=""):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), where
        for k in theirs:
            assert_trees_equal(ours[k], theirs[k], f"{where}/{k}")
        return
    a, b = np.asarray(ours), np.asarray(theirs)
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert np.array_equal(a, b), where


def sample_input(arch, seed=5):
    rng = np.random.default_rng(seed)
    if arch == "M5":
        return rng.standard_normal((3, WCFG.frame_size, 1)).astype(np.float32) * 0.1
    return rng.standard_normal((2, 48, 64, 1)).astype(np.float32)


def port_forward(model, x):
    """The port's forward on sed_tpu's NHWC / NWC numpy input."""
    t = torch.from_numpy(x)
    t = t.permute(0, 2, 1) if x.ndim == 3 else t.permute(0, 3, 1, 2)
    with torch.no_grad():
        return model.eval()(t).numpy()


# ---- the reader ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_reader_equals_flax_restore(arch, saved):
    _, _, path = saved[arch]
    with open(path, "rb") as f:
        theirs = serialization.msgpack_restore(f.read())
    ours = flax_ckpt.read_flax_checkpoint(path)
    assert_trees_equal(ours, theirs)
    assert int(ours["step"]) == 123
    assert set(ours["opt_state"]["0"]) == {"count", "mu", "nu", "nu_max"}
    assert set(ours["opt_state"]["0"]["mu"]) == set(ours["params"])


def test_reader_joins_chunked_arrays(saved, tmp_path, monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into chunk maps."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    _, state, _ = saved["M5"]
    path = jax_checkpoint.save_checkpoint(state, str(tmp_path), 2)
    with open(path, "rb") as f:
        blob = f.read()
    assert flax_ckpt.CHUNKED.encode() in blob
    ours = flax_ckpt.read_flax_checkpoint(path)
    assert_trees_equal(ours, serialization.msgpack_restore(blob))
    kernel = ours["params"]["Conv_1"]["kernel"]
    assert kernel.nbytes > 4096
    assert np.array_equal(kernel, np.asarray(state.params["Conv_1"]["kernel"]))


def test_reader_decodes_every_msgpack_form_flax_uses():
    """Every width of int, float, str, bin, array, map and ext, nil, bools,
    complex numbers and numpy scalars, as msgpack writes them."""
    tree = {
        "ints": [0, 5, 127, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
                 -2**63, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
        "floats": [0.5, -1e300],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "long": list(range(16)) + list(range(70000 - 16)),
        "map": {str(i): i for i in range(17)},
        "none": None, "yes": True, "no": False,
        "c": complex(1.5, -2.0),
        "arrays": [np.arange(n, dtype=d) for n in (0, 1, 2, 4, 8, 16, 100, 20000)
                   for d in (np.float32, np.int64, np.uint8)],
        "scalar": np.float32(3.25), "step": np.int32(9), "flag": np.bool_(True),
    }
    tree["map"].update({str(i): i for i in range(17, 70000)})
    blob = serialization.msgpack_serialize(tree)
    ours = flax_ckpt.decode(blob)
    theirs = serialization.msgpack_restore(blob)
    for key in ("ints", "strs", "bins", "long", "map", "none", "yes", "no", "c"):
        assert ours[key] == theirs[key], key
    assert ours["floats"] == theirs["floats"]
    for a, b in zip(ours["arrays"], theirs["arrays"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for key in ("scalar", "step", "flag"):
        assert type(ours[key]) is type(theirs[key]) and ours[key] == theirs[key], key
    # A float32, a complex number, and ext 8/16/32 lengths, which flax's
    # trees above do not all reach.
    assert flax_ckpt.decode(msgpack.packb(0.25, use_single_float=True)) == 0.25
    assert flax_ckpt.decode(msgpack.packb(
        msgpack.ExtType(flax_ckpt.EXT_COMPLEX, msgpack.packb([1.0, 2.0])))) == complex(1.0, 2.0)
    for n in (3, 300, 70000):
        payload = serialization._ndarray_to_bytes(np.arange(n, dtype=np.uint8))
        got = flax_ckpt.decode(msgpack.packb(msgpack.ExtType(flax_ckpt.EXT_NDARRAY, payload)))
        assert np.array_equal(got, np.arange(n, dtype=np.uint8))


@pytest.mark.parametrize("blob, where", [
    (b"\x81\xa1a\xc1", 3),                      # 0xc1: never used
    (b"\x81\xa1a\xc7\x01\x05x", 3),            # ext type 5
    (b"\x82\xa1a\x01", 4),                      # truncated map
    (b"\x01\x02", 1),                           # trailing bytes
    (msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb([[3], "object", b"xxx"]))}), 3),
    (msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb([[4], "float32", b"x" * 12]))}), 3),
])
def test_reader_refuses_malformed_bytes_naming_the_offset(blob, where, tmp_path):
    with pytest.raises(ValueError, match=f"at byte {where}"):
        flax_ckpt.decode(blob)
    path = tmp_path / "bad.ckpt"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match="at byte"):
        checkpoint.read_model_weights(str(path), "M5")


def test_reader_refuses_a_tree_that_is_not_a_train_state(tmp_path):
    path = tmp_path / "iteration_1.ckpt"
    path.write_bytes(serialization.msgpack_serialize({"params": {}}))
    with pytest.raises(ValueError, match="not a sed_tpu train state"):
        flax_ckpt.read_flax_checkpoint(str(path))


# ---- load_model_and_state -------------------------------------------------------


@pytest.mark.parametrize("fmt", ["ckpt", "pth", "pt"])
@pytest.mark.parametrize("arch", ARCHS)
def test_load_model_and_state_scores_like_sed_tpu(arch, fmt, saved, sed_tpu_scores,
                                                  sed_tpu_pth, tmp_path):
    """The .ckpt, its sed_tpu export (.pth) and the port's import of that
    (.pt) load to one model, scoring within 1e-5 of sed_tpu's
    load_model_and_state forward."""
    _, _, ckpt = saved[arch]
    x, want = sed_tpu_scores[arch]
    path = ckpt if fmt == "ckpt" else sed_tpu_pth[arch]
    if fmt == "pt":
        path = torch_import.import_torch_checkpoint(path, cli.build_model(arch, 1),
                                                    str(tmp_path / "run"), device="cpu")
        assert path.endswith("iteration_123.pt")
    cfg = WCFG if arch == "M5" else CFG
    model, state = cli.load_model_and_state(path, cfg, arch=arch, device="cpu")
    assert state.model is model and state.step == 0
    assert all(not s for s in state.optimizer.state.values())
    got = port_forward(model, x)
    want = want if arch != "M5" else want.reshape(got.shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_load_model_and_state_refuses_bf16_orbax_and_unknown(saved, tmp_path):
    _, _, ckpt = saved["M5"]
    # bf16=True, once refused, now builds the bf16 serving tier over the
    # same float32 weights (tests/test_torch_bf16.py holds it to sed_tpu's).
    model, _ = cli.load_model_and_state(ckpt, WCFG, arch="M5", bf16=True, device="cpu")
    assert model.dtype == torch.bfloat16 and model.fc.weight.dtype == torch.float32
    orbax = tmp_path / "iteration_5.ckpt.orbax"
    orbax.mkdir()
    with pytest.raises(ValueError, match="msgpack"):
        cli.load_model_and_state(str(orbax), WCFG, arch="M5", device="cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        cli.load_model_and_state(ckpt, WCFG, arch="M6", device="cpu")
    with pytest.raises(RuntimeError, match="Error"):
        cli.load_model_and_state(ckpt, CFG, arch="CnnAvgPooling", device="cpu")


def test_load_model_and_state_needs_a_card_unless_asked_for_the_cpu(saved):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.load_model_and_state(saved["M5"][2], WCFG, arch="M5")


# ---- export and import -----------------------------------------------------------


def assert_state_dicts_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_export_of_a_sed_tpu_checkpoint_equals_sed_tpus_bit_for_bit(arch, saved, sed_tpu_pth,
                                                                    tmp_path):
    _, _, ckpt = saved[arch]
    theirs = torch.load(sed_tpu_pth[arch], weights_only=False)
    ours = torch.load(torch_export.export_torch_checkpoint(
        ckpt, cli.build_model(arch, 1), str(tmp_path / "ours.pth"), device="cpu"),
        weights_only=True)
    assert ours["iterations"] == theirs["iterations"] == 123
    assert ours["optimizer"] == theirs["optimizer"] == {}
    assert_state_dicts_equal(ours["model"], theirs["model"])


@pytest.mark.parametrize("arch", ARCHS)
def test_pth_import_then_export_round_trips_bit_for_bit(arch, sed_tpu_pth, tmp_path):
    pth = sed_tpu_pth[arch]
    pt = torch_import.import_torch_checkpoint(pth, cli.build_model(arch, 1),
                                              str(tmp_path / "run"), device="cpu")
    saved_pt = torch.load(pt, weights_only=True)
    assert saved_pt["step"] == 123 and saved_pt["scheduler"]["last_epoch"] == 0
    back = torch.load(torch_export.export_torch_checkpoint(
        pt, cli.build_model(arch, 1), str(tmp_path / "back.pth"), device="cpu"),
        weights_only=True)
    ref = torch.load(pth, weights_only=False)
    assert back["iterations"] == 123
    assert_state_dicts_equal(back["model"], ref["model"])


def test_from_torch_checks_keys_and_shapes():
    model = cnn.CnnAvgPooling(1, SMALL)
    sd = model.state_dict()
    assert_state_dicts_equal(torch_import.cnn_avg_pooling_from_torch(sd, model), sd)
    with pytest.raises(ValueError, match="missing.*event_fc.bias"):
        torch_import.cnn_avg_pooling_from_torch(
            {k: v for k, v in sd.items() if k != "event_fc.bias"}, model)
    with pytest.raises(ValueError, match="unexpected.*extra"):
        torch_import.m5_from_torch({**sd, "extra": torch.zeros(1)}, model)
    with pytest.raises(ValueError, match=r"shapes.*event_fc.weight: \(2, 16\)"):
        torch_import.mobilenet_from_torch({**sd, "event_fc.weight": torch.zeros(2, 16)},
                                          model)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_clis_on_the_cpu(arch, saved, tmp_path, capsys):
    """``cli.export_torch`` of the .ckpt, then ``cli.import_torch`` of that
    .pth: the weights come back bit-equal, and each prints its JSON line."""
    _, _, ckpt = saved[arch]
    pth = str(tmp_path / "out.pth")
    export_cli.main(["--ckpt", ckpt, "--arch", arch, "--out", pth, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"pth": pth, "arch": arch, "classes": 1}
    import_cli.main(["--pth", pth, "--out", str(tmp_path / "run"), "--arch", arch,
                     "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ckpt"].endswith("checkpoints/iteration_123.pt") and line["arch"] == arch
    want, _ = checkpoint.read_model_weights(ckpt, arch)
    got = torch.load(line["ckpt"], weights_only=True)["model"]
    for k, v in want.items():
        if not k.endswith("num_batches_tracked") and not k.startswith("bn0."):
            assert torch.equal(got[k], v), k

"""The port's int8 PTQ (``ops/int8.py``, ``models/quantize.py``,
``models/convert.qparams_from_flax``) against sed_tpu's (CPU).

Models and inputs are sed_tpu's own tests' (tests/test_quantize.py: sizes,
seeds, recipe): CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) on 8 x 30 frames,
MobileNetV1 on 2 x 32 frames, M5 on 4 frames of 31,680 samples, each with
flax's init and two train-mode passes to move the BatchNorm statistics,
carried over by ``models.convert``.  Tolerances:

  * the int8 products: equal to exact integer arithmetic and to XLA's
    ``preferred_element_type=int32`` convolutions;
  * the port's artifact against sed_tpu's (same weights and calibration
    batch): int8 weights equal, weight scales within 1 ulp, activation
    scales and BatchNorm affines within 1e-5 relative;
  * sed_tpu's artifact through both packages (``qparams_from_flax``): the
    first int8 conv's int32 accumulators bit-equal, scores within 5e-3 (the
    band sed_tpu holds between its own two int8 graphs);
  * int8 against the port's own float32: max |dscore| < 0.05, and for
    CnnAvgPooling correlation > 0.999 (sed_tpu's classes, test_quantize.py
    :43-46 and :81); MobileNetV1 within sed_tpu's own int8 deviation on the
    same weights and input plus 10%;
  * M5's space-to-depth stem bit-equal to the direct one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.models import quantize as jq
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.cnn import TRAIN_CHANNEL_AND_POOL as FLAX_TRAIN_CONFIG
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu_torch.models import quantize as q
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          mobilenet_state_dict, qparams_from_flax)
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.ops import int8 as int8_ops

SCORE_BAND = 5e-3        # sed_tpu between its own two int8 graphs
FLOAT_BAND = 0.05        # int8 against float32 (tests/test_quantize.py)
MOBILENET_MARGIN = 1.1   # sed_tpu's own MobileNetV1 int8 deviation + 10%
REL = 1e-5
ODD_SHAPES = [(m, k, n) for m in (1, 5, 16) for k in (9, 79, 288, 1152) for n in (1, 11, 64)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trained_ish(flax_model, x, seed):
    """flax init, then two train-mode passes (sed_tpu's test recipe)."""
    # Jitted: one compile each, in place of an eager compile per operation.
    variables = jax.jit(lambda k, v: flax_model.init(k, v, train=False))(
        jax.random.key(seed), x)
    params, stats = variables["params"], variables["batch_stats"]
    train_pass = jax.jit(lambda p, s, v: flax_model.apply(
        {"params": p, "batch_stats": s}, v, train=True, mutable=["batch_stats"])[1])
    for _ in range(2):
        stats = train_pass(params, stats, x)["batch_stats"]
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))


class Family:
    """One family's flax model and port twin, sed_tpu's artifact, the port's,
    and each package's float and int8 outputs on the same input."""

    def __init__(self, name, flax_model, port, convert, x_flax, to_port, quantize,
                 jax_forward, port_forward, sigmoid, seed):
        self.name = name
        params, stats = trained_ish(flax_model, jnp.asarray(x_flax), seed)
        port.load_state_dict(convert(params, stats), strict=True)
        self.port = port.eval()
        self.x_flax, self.x = x_flax, to_port(x_flax)
        variables = {"params": params, "batch_stats": stats}
        jax_float = jax.jit(lambda v: flax_model.apply(variables, v, train=False))
        self.q_jax_raw = getattr(jq, quantize)(flax_model, params, stats, [x_flax])
        self.q_jax = jax.tree.map(np.asarray, self.q_jax_raw)
        jax_int8 = jax.jit(lambda v: getattr(jq, jax_forward)(self.q_jax_raw, v))
        act = jax.nn.sigmoid if sigmoid else (lambda v: v)
        self.jax_float = np.asarray(act(jax_float(jnp.asarray(x_flax))))
        self.jax_int8 = np.asarray(act(jax_int8(jnp.asarray(x_flax))))
        self.q_port = getattr(q, quantize)(self.port, [self.x])
        self.q_carried = qparams_from_flax(self.q_jax)
        self.forward = getattr(q, port_forward)
        tsig = torch.sigmoid if sigmoid else (lambda v: v)
        with torch.no_grad():
            self.port_float = tsig(self.port(torch.from_numpy(self.x))).numpy()
        self.port_int8 = tsig(self.forward(self.q_port, torch.from_numpy(self.x))).numpy()
        self.carried_int8 = tsig(self.forward(self.q_carried, torch.from_numpy(self.x))).numpy()


@pytest.fixture(scope="module")
def families():
    spec = JaxSpectrogramConfig()
    wave = JaxWaveformConfig()
    nchw = lambda a: np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))  # noqa: E731
    ncw = lambda a: np.ascontiguousarray(np.transpose(a, (0, 2, 1)))      # noqa: E731

    def draw(seed, shape, scale=1.0):
        # sed_tpu's tests draw each family's input and init from one seed.
        return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)

    return {
        "CnnAvgPooling": Family(
            "CnnAvgPooling", FlaxCnn(classes_num=1, model_config=FLAX_TRAIN_CONFIG),
            CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL), cnn_avg_pooling_state_dict,
            draw(0, (8, spec.train_crop_size, spec.mel_bins, 1)), nchw, "quantize_cnn",
            "quantized_cnn_forward", "quantized_cnn_forward", True, 0),
        "MobileNetV1": Family(
            "MobileNetV1", FlaxMobileNetV1(classes_num=1), MobileNetV1(1),
            mobilenet_state_dict, draw(4, (2, 32, spec.mel_bins, 1)), nchw,
            "quantize_mobilenet", "quantized_mobilenet_forward", "quantized_mobilenet_forward",
            False, 4),
        "M5": Family(
            "M5", FlaxM5(classes_num=1), M5(1), m5_state_dict,
            draw(3, (4, wave.frame_size, 1), 0.1), ncw, "quantize_m5", "quantized_m5_forward",
            "quantized_m5_forward", True, 3),
    }


# ---------------------------------------------------------------------------
# ops/int8.py
# ---------------------------------------------------------------------------


def int8_pair(rng, *shapes):
    return [torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8)) for s in shapes]


@pytest.mark.parametrize("m,k,n", ODD_SHAPES)
def test_int8_matmul_is_exact_at_odd_shapes(m, k, n):
    """The plain version, and the padded operands ``_int_mm`` gets on the
    card (here through the CPU's ``_int_mm``), equal integer arithmetic."""
    a, b = int8_pair(np.random.default_rng(m * k + n), (m, k), (k, n))
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    int8_ops.reset_launch_counts()
    got = int8_ops.int8_matmul(a, b)
    assert got.dtype == torch.int32 and int8_ops.LAUNCHES["int_mm"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_ops.int_mm_padded(a, b).numpy(), want)


def test_int8_matmul_refuses_wrong_dtypes_shapes_and_devices():
    a, b = int8_pair(np.random.default_rng(1), (4, 8), (8, 3))
    with pytest.raises(TypeError):
        int8_ops.int8_matmul(a.float(), b)
    with pytest.raises(ValueError, match="shapes"):
        int8_ops.int8_matmul(a, b.t())
    with pytest.raises(ValueError, match="unsupported device"):
        int8_ops.int8_matmul(a.to("meta"), b.to("meta"))


@pytest.mark.parametrize("cin,cout,k,pad", [(1, 32, 3, 1), (32, 64, 3, 1), (64, 11, 1, 0)])
def test_int8_conv2d_nhwc_equals_xla_int32_conv(cin, cout, k, pad):
    rng = np.random.default_rng(cin + cout)
    x, w = int8_pair(rng, (2, 7, 10, cin), (cout, cin, k, k))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(np.transpose(w.numpy(), (2, 3, 1, 0))), (1, 1),
        [(pad, pad), (pad, pad)], dimension_numbers=jq.DN, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(int8_ops.int8_conv2d_nhwc(x, w, pad).numpy(), np.asarray(want))


@pytest.mark.parametrize("cin,cout,k,stride,pad", [(1, 64, 79, 4, 39), (64, 128, 3, 1, 1),
                                                    (16, 8, 7, 1, 0)])
def test_int8_conv1d_nwc_equals_xla_int32_conv(cin, cout, k, stride, pad):
    rng = np.random.default_rng(k)
    x, w = int8_pair(rng, (3, 203, cin), (cout, cin, k))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(np.transpose(w.numpy(), (2, 1, 0))), (stride,),
        [(pad, pad)], dimension_numbers=jq.DN1, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(int8_ops.int8_conv1d_nwc(x, w, stride, pad).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# models/quantize.py and qparams_from_flax
# ---------------------------------------------------------------------------

FAMILIES = ["CnnAvgPooling", "MobileNetV1", "M5"]


def quantized_entries(qp):
    """Every int8 layer of an artifact (convs, pointwise convs, dense heads)."""
    if "dense1" in qp:
        return [b for b in qp["blocks"] if b["kind"] == "dw"] + [qp["dense0"], qp["dense1"]]
    if "convs" in qp:
        return qp["convs"] + [qp["dense"]]
    return [c for layer in qp["layers"] for c in layer["convs"]] + [qp["dense"]]


def flatten(qp, prefix=""):
    if isinstance(qp, dict):
        return {k2: v2 for k, v in qp.items() for k2, v2 in flatten(v, f"{prefix}{k}.").items()}
    if isinstance(qp, list):
        return {k2: v2 for i, v in enumerate(qp) for k2, v2 in flatten(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: qp}


@pytest.mark.parametrize("name", FAMILIES)
def test_port_artifact_matches_sed_tpu(families, name):
    """Same weights, same calibration batch: int8 weights equal, weight
    scales within 1 ulp, activation scales and affines within 1e-5."""
    fam = families[name]
    ours, theirs = flatten(fam.q_port), flatten(fam.q_carried)
    assert ours.keys() == theirs.keys()
    for key, mine in ours.items():
        other = theirs[key]
        if not torch.is_tensor(mine):
            assert mine == other, key          # the statics
            continue
        assert mine.dtype == other.dtype and mine.shape == other.shape, key
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "qweight":
            assert torch.equal(mine, other), key
        elif leaf == "w_scale":
            ulp = np.spacing(np.abs(other.numpy()))
            assert np.all(np.abs(mine.numpy() - other.numpy()) <= ulp), key
        else:
            np.testing.assert_allclose(mine.numpy(), other.numpy(), rtol=REL, atol=0,
                                       err_msg=key)
    for entry in quantized_entries(fam.q_port):
        assert entry["qweight"].dtype == torch.int8
        assert entry["w_scale"].shape == (entry["qweight"].shape[0],)


def first_int8_layer(fam):
    """(port's int8 input, sed_tpu's int8 input, weight) of the family's first
    int8 conv, each package quantizing its own float activations."""
    x = torch.from_numpy(fam.x)
    if fam.name == "CnnAvgPooling":
        c = fam.q_carried["layers"][0]["convs"][0]
        return (q._quantize_act(x.permute(0, 2, 3, 1), c["act_scale"]),
                jq._quantize_act(jnp.asarray(fam.x_flax), fam.q_jax_raw["layers"][0]["convs"][0][
                    "act_scale"]), c["qweight"])
    if fam.name == "M5":
        c = fam.q_carried["convs"][0]
        return (q._quantize_act(x.permute(0, 2, 1), c["act_scale"]),
                jq._quantize_act(jnp.asarray(fam.x_flax),
                                 fam.q_jax_raw["convs"][0]["act_scale"]), c["qweight"])
    # MobileNetV1: the pointwise conv of block 1, after the float stages.
    blk0, blk1 = fam.q_carried["blocks"][:2]
    jb0, jb1 = fam.q_jax_raw["blocks"][:2]
    h = x.permute(0, 2, 3, 1)
    for b in (blk0, blk1):
        groups = 1 if b["kind"] == "bn" else h.shape[-1]
        h = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), b["dw_kernel"], padding=1,
                                       groups=groups).permute(0, 2, 3, 1)
        if b["stride"] > 1:
            h = q._avg_pool_nhwc(h, b["stride"])
        h = torch.relu(h * b["bn0_gain"] + b["bn0_bias"])
    j = jnp.asarray(fam.x_flax)
    for b in (jb0, jb1):
        groups = 1 if b["kind"] == "bn" else j.shape[-1]
        j = jax.lax.conv_general_dilated(j, b["dw_kernel"], (1, 1), [(1, 1), (1, 1)],
                                         dimension_numbers=jq.DN, feature_group_count=groups)
        if b["stride"] > 1:
            s = b["stride"]
            j = jax.lax.reduce_window(j, 0.0, jax.lax.add, (1, s, s, 1), (1, s, s, 1),
                                      "VALID") / (s * s)
        j = jnp.maximum(j * b["bn0_gain"] + b["bn0_bias"], 0.0)
    return (q._quantize_act(h, blk1["act_scale"]), jq._quantize_act(j, jb1["act_scale"]),
            blk1["qweight"])


@pytest.mark.parametrize("name", FAMILIES)
def test_first_int8_conv_accumulators_are_bit_equal(families, name):
    """sed_tpu's artifact in both packages: the int8 input of the first int8
    conv (each package quantizing its own float activations; equal for the
    families whose first int8 conv reads the input itself) and, on the same
    int8 input, the int32 accumulators bit for bit."""
    fam = families[name]
    ours, theirs, w = first_int8_layer(fam)
    theirs = np.asarray(theirs)
    flips = float(np.mean(ours.numpy() != theirs))
    print(f"{name}: share of first-int8-conv inputs that differ {flips:.3e}")
    if name != "MobileNetV1":
        assert flips == 0.0
    x = torch.from_numpy(theirs.copy())
    if name == "M5":
        c = fam.q_jax_raw["convs"][0]
        got = int8_ops.int8_conv1d_nwc(x, w, c["stride"], c["pad"])
        want = jax.lax.conv_general_dilated(
            jnp.asarray(theirs), c["qweight"], (c["stride"],), [(c["pad"], c["pad"])],
            dimension_numbers=jq.DN1, preferred_element_type=jnp.int32)
    else:
        jw = (fam.q_jax_raw["layers"][0]["convs"][0]["qweight"] if name == "CnnAvgPooling"
              else fam.q_jax_raw["blocks"][1]["qweight"])
        pad = (jw.shape[0] - 1) // 2
        got = int8_ops.int8_conv2d_nhwc(x, w, pad)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(theirs), jw, (1, 1), [(pad, pad), (pad, pad)],
            dimension_numbers=jq.DN, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FAMILIES)
def test_same_artifact_scores_as_sed_tpu(families, name):
    """sed_tpu's artifact carried across by ``qparams_from_flax`` scores
    within 5e-3 of sed_tpu's int8 forward on the same input."""
    fam = families[name]
    got, want = fam.carried_int8, fam.jax_int8
    assert got.shape == want.shape
    diff = np.abs(got - want)
    print(f"{name}: same artifact, port vs sed_tpu max {diff.max():.3e}, "
          f"share of outputs that differ {np.mean(diff > 0):.3e}")
    assert diff.max() < SCORE_BAND


@pytest.mark.parametrize("name", FAMILIES)
def test_int8_follows_the_float_model(families, name):
    """The port's own artifact against the port's float32 forward, at
    sed_tpu's fidelity class; MobileNetV1 at sed_tpu's own int8 deviation
    on the same weights and input, plus 10%."""
    fam = families[name]
    got, ref = fam.port_int8, fam.port_float
    assert got.shape == ref.shape
    dev = float(np.abs(got - ref).max())
    corr = float(np.corrcoef(got.ravel(), ref.ravel())[0, 1])
    jax_dev = float(np.abs(fam.jax_int8 - fam.jax_float).max())
    jax_corr = float(np.corrcoef(fam.jax_int8.ravel(), fam.jax_float.ravel())[0, 1])
    print(f"{name}: port int8 vs float max {dev:.3e} corr {corr:.6f}; "
          f"sed_tpu's int8 vs float {jax_dev:.3e} corr {jax_corr:.6f}")
    if name == "MobileNetV1":
        assert dev <= MOBILENET_MARGIN * jax_dev
    elif name == "M5":
        # sed_tpu's M5 class is the max alone (tests/test_quantize.py:81):
        # four scores, whose correlation sed_tpu's own int8 puts at ~0.98.
        assert dev < FLOAT_BAND
    else:
        assert dev < FLOAT_BAND and corr > 0.999


def test_m5_int8_holds_a_loud_transient(families):
    """The dense head's scale is calibrated on the per-timestep activations
    before the time mean, so a loud transient does not clip (sed_tpu's
    regression test, on the port's own artifact)."""
    fam = families["M5"]
    x = fam.x.copy()
    x[:, 0, 1000:1100] += 0.9
    qp = q.quantize_m5(fam.port, [x])
    with torch.no_grad():
        ref = torch.sigmoid(fam.port(torch.from_numpy(x)))
    got = torch.sigmoid(q.quantized_m5_forward(qp, torch.from_numpy(x)))
    assert float((got - ref).abs().max()) < FLOAT_BAND


def test_m5_s2d_stem_is_bit_equal_to_direct(families):
    fam = families["M5"]
    x = torch.from_numpy(fam.x[:3])
    direct = q.quantized_m5_forward(fam.q_port, x)
    s2d = q.quantized_m5_forward(fam.q_port, x, conv1_impl="s2d")
    assert torch.equal(direct, s2d)
    with pytest.raises(ValueError, match="conv1_impl"):
        q.quantized_m5_forward(fam.q_port, x, conv1_impl="bogus")


def test_serving_scores_dispatch_on_the_artifact(families):
    """``quantized_serving_scores`` reads the family from the artifact:
    MobileNetV1's emits sigmoid itself, CnnAvgPooling's gets one here (as
    ``quantized_scores``)."""
    cnn, mob = families["CnnAvgPooling"], families["MobileNetV1"]
    x = torch.from_numpy(cnn.x)
    np.testing.assert_array_equal(q.quantized_serving_scores(cnn.q_port, x).numpy(),
                                  cnn.port_int8)
    np.testing.assert_array_equal(q.quantized_scores(cnn.q_port, x).numpy(), cnn.port_int8)
    np.testing.assert_array_equal(
        q.quantized_serving_scores(mob.q_port, torch.from_numpy(mob.x)).numpy(), mob.port_int8)


def test_artifact_lives_on_the_model_device_and_moves(families):
    fam = families["CnnAvgPooling"]
    leaves = flatten(fam.q_port)
    assert all(v.device.type == "cpu" for v in leaves.values() if torch.is_tensor(v))
    moved = q.qparams_to(fam.q_port, "meta")
    assert all(v.device.type == "meta" for v in flatten(moved).values() if torch.is_tensor(v))
    assert moved["interp"] == fam.q_port["interp"] == 8
    assert [layer["pool"] for layer in moved["layers"]] == [2, 2, 2, 1]


@pytest.mark.parametrize("name", FAMILIES)
def test_quantize_model_picks_the_family(families, name):
    """``quantize_model`` (the one entry the CLIs calibrate through) builds
    the family's artifact and returns the forward that scores it."""
    fam = families[name]
    suffix = {"CnnAvgPooling": "cnn", "MobileNetV1": "mobilenet", "M5": "m5"}[name]
    qp, forward = q.quantize_model(fam.port, [fam.x])
    assert forward is getattr(q, f"quantized_{suffix}_forward")
    want, got = flatten(getattr(q, f"quantize_{suffix}")(fam.port, [fam.x])), flatten(qp)
    assert want.keys() == got.keys()
    for key, value in want.items():
        assert (torch.equal(got[key], value) if torch.is_tensor(value)
                else got[key] == value), key

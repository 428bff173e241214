"""The port's serving artifacts (``sed_tpu_torch.export``) against sed_tpu's
(CPU): K1 and K2 as custom operators, the AOT pipelines of the three
families in float32, int8 and µ-law, the scorer tier, and the
``sed_tpu_torch-aot-v1`` container's refusals and library install.

sed_tpu's artifacts are built once per module (its AOT compile dominates
this file's time) at its own test sizes: 8 kHz, B = 2, 4 s, CnnAvgPooling
((8, 2), (16, 2)); weights and BatchNorm statistics seeded in flax and
carried across by ``models/convert.py``, int8 artifacts by
``qparams_from_flax``.  Tolerances: float32 scores within 1e-5 (the
port's budget against sed_tpu); int8 within 5e-3 (the band between
sed_tpu's own two int8 graphs, tests/test_torch_quantize.py); the port's
exported program against its own eager forward: equal.
"""

import io
import json
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sed_tpu import export as jex
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data.events import frame_coverage_labels
from sed_tpu.models import quantize as jq
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.ops.featurizer import logmel_features_batch as jax_logmel_batch
from sed_tpu.ops.mulaw import mulaw_encode
from sed_tpu_torch import export as ex
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.models.cnn import CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          mobilenet_state_dict, qparams_from_flax)
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.models.quantize import quantized_scores
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.featurizer import logmel_features_batch

SMALL = dict(working_sample_rate=8000, time_margin=0.33)
CFG, JCFG = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
WCFG, JWCFG = WaveformConfig(**SMALL), JaxWaveformConfig(**SMALL)
NARROW = ((8, 2), (16, 2))
B, SAMPLES = 2, 4 * 8000
ATOL = 1e-5
BAND = 5e-3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(flax_model, sample, seed):
    """flax params and batch stats of ``flax_model`` with seeded scales,
    biases and BatchNorm statistics (numpy trees)."""
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


def pcm_batch(seed, samples=SAMPLES, scale=4000):
    return (np.random.default_rng(seed).standard_normal((B, samples, 1)) * scale).astype(np.int16)


class Family:
    def __init__(self, flax_model, port, params, stats):
        self.flax, self.port, self.params, self.stats = flax_model, port, params, stats


@pytest.fixture(scope="module")
def fams():
    frames = 1 + SAMPLES // JCFG.hop_size
    spec_sample = jnp.zeros((1, frames, JCFG.mel_bins, 1))
    out = {}
    for name, flax_model, port, convert, sample, seed in (
            ("CnnAvgPooling", FlaxCnn(classes_num=1, model_config=NARROW),
             CnnAvgPooling(1, NARROW), cnn_avg_pooling_state_dict, spec_sample, 0),
            ("MobileNetV1", FlaxMobileNetV1(classes_num=1, emit="logits"),
             MobileNetV1(1, emit="logits"), mobilenet_state_dict, spec_sample, 1),
            ("M5", FlaxM5(classes_num=1), M5(1), m5_state_dict,
             jnp.zeros((1, JWCFG.frame_size, 1)), 2)):
        params, stats = seeded(flax_model, sample, seed)
        port.load_state_dict(convert(params, stats), strict=True)
        out[name] = Family(flax_model, port.eval(), params, stats)
    return out


@pytest.fixture(scope="module")
def norm():
    feats = np.asarray(jax_logmel_batch(jnp.asarray(pcm_batch(9)), JCFG))
    return feats.mean(axis=(0, 1, 2)), feats.std(axis=(0, 1, 2))


# ---------------------------------------------------------------------------
# K1 and K2 as custom operators
# ---------------------------------------------------------------------------

def op_args(name):
    waves = torch.from_numpy(pcm_batch(1)[..., 0].astype(np.float32) / 32768.0)
    window = kernels.stft_window(CFG, CPU)
    if name == "wave_stft_power":
        return torch.ops.sed_tpu_torch.wave_stft_power, (waves, window, CFG.hop_size, CFG.nfft)
    if name == "wave_dft_power_bf16":
        return (torch.ops.sed_tpu_torch.wave_dft_power_bf16,
                (waves, window, CFG.hop_size, CFG.nfft, 3, 1))
    power = kernels.wave_stft_power(waves, window, CFG.hop_size, CFG.nfft).reshape(-1, CFG.freq_bins)
    bands = kernels.mel_bands(CFG, CPU)
    return torch.ops.sed_tpu_torch.mel_log, (power, bands.segments, bands.band_first, bands.work,
                                             bands.weights, bands.dense, *bands.span)


@pytest.mark.parametrize("name", ["wave_stft_power", "mel_log", "wave_dft_power_bf16"])
def test_custom_ops_pass_opcheck(name):
    """Schema, fake kernel, autograd registration and AOT dispatch of each
    operator, on the CPU (its kernel there is the plain version)."""
    op, args = op_args(name)
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result


@pytest.mark.parametrize("name", ["wave_stft_power", "mel_log", "wave_dft_power_bf16"])
def test_custom_ops_equal_the_plain_versions_and_fake_their_shapes(name):
    op, args = op_args(name)
    got = op(*args)
    if name == "wave_stft_power":
        want = kernels.wave_stft_power_plain(*args)
    elif name == "wave_dft_power_bf16":
        want = kernels.wave_dft_power_bf16_plain(*args[:4], ("bf16x3", "bf16x1"))
    else:
        want = kernels.mel_log_plain(args[0], args[5])
    assert torch.equal(got, want)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    assert fake.shape == want.shape and fake.dtype == want.dtype


def test_traced_tables_are_not_cached_as_fake_tensors():
    """A device table first made while torch.export traces is a fake tensor:
    the cache returns it to the tracer and keeps nothing, so the next eager
    call gets a real one."""
    cfg = SpectrogramConfig(working_sample_rate=8001, time_margin=0.33)   # a cold cache

    class Table(torch.nn.Module):
        def forward(self, x):
            return x * kernels.stft_window(cfg, CPU)[: x.shape[0]]

    program = torch.export.export(Table(), (torch.ones(4),))
    window = kernels.stft_window(cfg, CPU)
    assert not isinstance(window, torch._subclasses.FakeTensor)
    assert torch.equal(program.module()(torch.ones(4)), window[:4])


# ---------------------------------------------------------------------------
# The AOT pipelines against sed_tpu's
# ---------------------------------------------------------------------------

def jax_pipeline(score_fn, weights, samples=SAMPLES, cfg=JCFG, **kw):
    return jex.load_aot_pipeline(jex.aot_export_pipeline(score_fn, weights, B, samples, cfg,
                                                         **kw))


@pytest.fixture(scope="module")
def jax_f32(fams, norm):
    """sed_tpu's float32 artifacts of both spectrogram families, normalized."""
    return {name: jax_pipeline(*jex.cnn_serving(fams[name].flax, fams[name].params,
                                                fams[name].stats, *norm))
            for name in ("CnnAvgPooling", "MobileNetV1")}


@pytest.mark.parametrize("use_pallas", ["auto", False])
@pytest.mark.parametrize("name", ["CnnAvgPooling", "MobileNetV1"])
def test_f32_pipeline_matches_sed_tpu(fams, norm, jax_f32, name, use_pallas):
    """int16 PCM -> featurizer (K1 + K2 as operators, or PyTorch ops) ->
    CNN -> sigmoid: within 1e-5 of sed_tpu's artifact; the graph holds K1
    and K2 exactly when the featurizer is 'auto'."""
    pcm = pcm_batch(2)
    blob = ex.aot_export_pipeline(ex.cnn_serving(fams[name].port, *norm), B, SAMPLES, CFG,
                                  use_pallas=use_pallas, meta={"arch": name}, device="cpu")
    call = ex.load_aot_pipeline(blob)
    got, want = call(pcm), jax_f32[name](pcm)
    assert got.shape == want.shape and got.dtype == np.float32
    print(f"{name} use_pallas={use_pallas}: port vs sed_tpu {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert call.header["custom_ops"] == (["mel_log", "wave_stft_power"] if use_pallas else [])
    if use_pallas:   # the featurizer's tables are the program's constants, made once
        assert "lift_fresh_copy" not in call.module.code
    assert call.meta == {"arch": name} and call.input_shape == (B, SAMPLES, 1)
    assert call.input_dtype == "int16" and call.device_kind == "cpu"
    assert call.header["kernel_library"] is None    # a CPU program carries none
    with pytest.raises(ValueError, match="expects audio"):
        call(pcm[:1])


def test_exported_program_equals_the_eager_forward(fams, norm):
    """The loaded program against the same head called eagerly on the
    port's featurizer: equal."""
    head = ex.cnn_serving(fams["CnnAvgPooling"].port, *norm)
    call = ex.load_aot_pipeline(ex.aot_export_pipeline(head, B, SAMPLES, CFG, device="cpu"))
    pcm = pcm_batch(3)
    with torch.no_grad():
        want = head(logmel_features_batch(torch.from_numpy(pcm), CFG)).numpy()
    np.testing.assert_array_equal(call(pcm), want)


@pytest.mark.parametrize("tier, sharded", [("fast", False), ("turbo", False), ("fast", True)])
def test_fast_tier_program_equals_the_eager_forward(fams, norm, tier, sharded):
    """A reduced tier bakes K1t into the graph as the custom operator
    ``sed_tpu_torch::wave_dft_power_bf16`` (its passes as arguments), with
    and without a mesh (here one rank's: the program is traced on its rows);
    the loaded program equals the head called eagerly on the port's
    featurizer at that tier."""
    from sed_tpu_torch.ops.featurizer import resolve_featurizer_precision
    from sed_tpu_torch.parallel.mesh import Mesh

    head = ex.cnn_serving(fams["CnnAvgPooling"].port, *norm)
    mesh = Mesh(None, 1, 0, CPU) if sharded else None
    blob = ex.aot_export_pipeline(head, B, SAMPLES, CFG, featurizer_precision=tier,
                                  mesh=mesh, device="cpu")
    call = ex.load_aot_pipeline(blob)
    assert call.header["custom_ops"] == ["mel_log", "wave_dft_power_bf16"]
    pcm = pcm_batch(5)
    precision = resolve_featurizer_precision(tier)
    with torch.no_grad():
        want = head(logmel_features_batch(torch.from_numpy(pcm), CFG,
                                          pallas_precision=precision)).numpy()
    np.testing.assert_array_equal(call(pcm), want)


@pytest.mark.parametrize("name", ["CnnAvgPooling", "MobileNetV1"])
def test_int8_pipeline_matches_sed_tpu(fams, norm, name):
    """sed_tpu's int8 artifact, calibrated on its features and carried
    across by qparams_from_flax, exported by both packages: within 5e-3."""
    fam = fams[name]
    pcm = pcm_batch(4)
    feats = (np.asarray(jax_logmel_batch(jnp.asarray(pcm), JCFG)) - norm[0]) / norm[1]
    calib = [np.transpose(feats, (0, 2, 3, 1))]
    if name == "MobileNetV1":
        q = jq.quantize_mobilenet(fam.flax, fam.params, fam.stats, calib)
        jax_head, port_head = jex.mobilenet_quantized_serving, ex.mobilenet_quantized_serving
    else:
        q = jq.quantize_cnn(fam.flax, fam.params, fam.stats, calib)
        jax_head, port_head = jex.quantized_serving, ex.quantized_serving
    want = jax_pipeline(*jax_head(q, *norm))(pcm)
    qp = qparams_from_flax(jax.tree.map(np.asarray, q))
    call = ex.load_aot_pipeline(ex.aot_export_pipeline(port_head(qp, *norm), B, SAMPLES, CFG,
                                                       device="cpu"))
    got = call(pcm)
    print(f"{name} int8: port vs sed_tpu {np.abs(got - want).max():.3e}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BAND)


def test_int8_program_equals_the_eager_int8_forward(fams):
    """The exported int8 program (the artifact's tensors as buffers) against
    ``quantized_scores`` called eagerly: equal."""
    from sed_tpu_torch.models.quantize import quantize_cnn

    pcm = pcm_batch(5)
    feats = logmel_features_batch(torch.from_numpy(pcm), CFG)
    qp = quantize_cnn(fams["CnnAvgPooling"].port, [feats])
    call = ex.load_aot_pipeline(ex.aot_export_pipeline(ex.quantized_serving(qp), B, SAMPLES,
                                                       CFG, device="cpu"))
    np.testing.assert_array_equal(call(pcm), quantized_scores(qp, feats).numpy())


def m5_windows(pcm_row):
    frames, _ = frame_coverage_labels((pcm_row.astype(np.float32) / 32768.0)[None], [], [],
                                      JWCFG)
    return frames   # (n, 1, frame)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_m5_pipeline_matches_sed_tpu(fams, tier):
    """int16 PCM -> hop-strided windows (unfold) -> M5 -> sigmoid against
    sed_tpu's ``aot_export_m5_pipeline``: float32 within 1e-5, int8 (sed_tpu's
    artifact carried across) within 5e-3; and equal to the eager head on the
    offline validation split's frames."""
    fam = fams["M5"]
    samples = 4 * JWCFG.frame_size + 123
    pcm = pcm_batch(6, samples, 3000)
    if tier == "f32":
        jax_head, head = jex.m5_serving(fam.flax, fam.params, fam.stats), ex.m5_serving(fam.port)
        tol = ATOL
    else:
        calib = [np.transpose(np.concatenate([m5_windows(p[:, 0]) for p in pcm]), (0, 2, 1))]
        q = jq.quantize_m5(fam.flax, fam.params, fam.stats, calib)
        jax_head = jex.m5_quantized_serving(q)
        head = ex.m5_quantized_serving(qparams_from_flax(jax.tree.map(np.asarray, q)))
        tol = BAND
    want = jex.load_aot_pipeline(jex.aot_export_m5_pipeline(*jax_head, B, samples, JWCFG))(pcm)
    call = ex.load_aot_pipeline(ex.aot_export_m5_pipeline(head, B, samples, WCFG,
                                                          device="cpu"))
    got = call(pcm)
    print(f"M5 {tier}: port vs sed_tpu {np.abs(got - want).max():.3e}")
    assert got.shape == want.shape == (B, (samples - 2 * (WCFG.frame_size // 2))
                                       // WCFG.hop_size + 1, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    windows = np.concatenate([m5_windows(p[:, 0]) for p in pcm])   # the same batch
    with torch.no_grad():
        eager = head(torch.from_numpy(windows)).numpy()
    np.testing.assert_array_equal(got.reshape(eager.shape), eager)


def test_m5_pipeline_refuses_audio_shorter_than_a_frame(fams):
    with pytest.raises(ValueError, match="yields no"):
        ex.aot_export_m5_pipeline(ex.m5_serving(fams["M5"].port), B, WCFG.frame_size - 2, WCFG,
                                  device="cpu")


def test_generic_export_of_the_m5_window_scorer(fams):
    """``aot_export_fn`` of the M5 head on (N, 1, frame) windows, as
    sed_tpu's test_aot_m5_and_generic_export: equal to the direct forward."""
    fam = fams["M5"]
    x = (np.random.default_rng(7).standard_normal((4, 1, WCFG.frame_size)) * 0.1) \
        .astype(np.float32)
    head = ex.m5_serving(fam.port)
    call = ex.load_aot_pipeline(ex.aot_export_fn(head, torch.zeros(4, 1, WCFG.frame_size)))
    with torch.no_grad():
        np.testing.assert_array_equal(call(x), head(torch.from_numpy(x)).numpy())


def test_uint8_pipeline_and_raw_loader(fams):
    """The µ-law artifact (tests/test_ingest.py:111's counterpart): uint8
    bytes, int16 and float audio (encoded by the host bridge) against
    sed_tpu's uint8 artifact within 1e-5; ``load_aot_fn`` takes and returns
    tensors."""
    fam = fams["CnnAvgPooling"]
    samples = 2 * CFG.working_sample_rate
    pcm = (np.random.default_rng(2).standard_normal((B, samples, 1)) * 9000).astype(np.int16)
    u8 = mulaw_encode(pcm)
    want = jax_pipeline(*jex.cnn_serving(fam.flax, fam.params, fam.stats), samples,
                        pcm_dtype=jnp.uint8, use_pallas=False)(u8)
    blob = ex.aot_export_pipeline(ex.cnn_serving(fam.port), B, samples, CFG,
                                  pcm_dtype=torch.uint8, device="cpu")
    call = ex.load_aot_pipeline(blob)
    assert call.input_dtype == "uint8"
    for audio in (u8, pcm, pcm.astype(np.float32) / 32768.0):
        np.testing.assert_allclose(call(audio), want, rtol=0, atol=ATOL)
    raw = ex.load_aot_fn(blob)
    out = raw(torch.from_numpy(u8))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_scorer_tier_matches_sed_tpu(fams, tier):
    """``export_scorer`` / ``export_quantized_scorer`` + ``load_scorer``:
    features (the port's NCHW, sed_tpu's NHWC) -> sigmoid scores, within
    1e-5 (int8: 5e-3) of sed_tpu's StableHLO scorer; no kernel library."""
    fam = fams["CnnAvgPooling"]
    x = np.random.default_rng(8).standard_normal((2, 1, 32, CFG.mel_bins)).astype(np.float32)
    nhwc = np.transpose(x, (0, 2, 3, 1))
    if tier == "f32":
        want = jex.load_scorer(jex.export_scorer(fam.flax, fam.params, fam.stats, 2, 32,
                                                 JCFG))(nhwc)
        blob, tol = ex.export_scorer(fam.port, 2, 32, CFG, device="cpu"), ATOL
    else:
        q = jq.quantize_cnn(fam.flax, fam.params, fam.stats, [nhwc])
        want = jex.load_scorer(jex.export_quantized_scorer(q, 2, 32, JCFG))(nhwc)
        qp = qparams_from_flax(jax.tree.map(np.asarray, q))
        blob, tol = ex.export_quantized_scorer(qp, 2, 32, CFG, device="cpu"), BAND
    scorer = ex.load_scorer(blob)
    assert scorer.header["custom_ops"] == [] and scorer.header["kernel_library"] is None
    got = scorer(x)
    print(f"scorer {tier}: port vs sed_tpu {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_bf16_pipeline_follows_sed_tpu(fams):
    """A bfloat16 CnnAvgPooling artifact against sed_tpu's bf16 artifact on
    the same weights: within sed_tpu's bf16 band on scores (0.05,
    tests/test_stream_pool.py:737); its header says so through ``meta``."""
    fam = fams["CnnAvgPooling"]
    pcm = pcm_batch(10)
    jmodel = FlaxCnn(classes_num=1, model_config=NARROW, dtype=jnp.bfloat16)
    want = jax_pipeline(*jex.cnn_serving(jmodel, fam.params, fam.stats))(pcm)
    port = CnnAvgPooling(1, NARROW, dtype=torch.bfloat16)
    port.load_state_dict(fam.port.state_dict())
    call = ex.load_aot_pipeline(ex.aot_export_pipeline(
        ex.cnn_serving(port), B, SAMPLES, CFG, meta={"dtype": "bfloat16"}, device="cpu"))
    got = call(pcm)
    f32 = ex.load_aot_pipeline(ex.aot_export_pipeline(ex.cnn_serving(fam.port), B, SAMPLES,
                                                      CFG, device="cpu"))(pcm)
    print(f"bf16 artifact: port vs sed_tpu {np.abs(got - want).max():.3e}; "
          f"port bf16 vs f32 {np.abs(got - f32).max():.3e}")
    assert got.dtype == np.float32 and call.meta == {"dtype": "bfloat16"}
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blob(fams):
    return ex.aot_export_pipeline(ex.cnn_serving(fams["CnnAvgPooling"].port), B, SAMPLES, CFG,
                                  device="cpu")


def with_header(blob, **changes):
    """``blob`` with its header's fields replaced."""
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        for name in src.namelist():
            data = src.read(name)
            if name == "header.json":
                header = json.loads(data)
                header.update(changes)
                data = json.dumps(header).encode()
            z.writestr(name, data)
    return out.getvalue()


UNPICKLED = []


class _Trap:
    """Records that it was unpickled."""

    def __reduce__(self):
        return UNPICKLED.append, ("unpickled",)


def test_container_refuses_a_sed_tpu_pickle_without_unpickling_it():
    blob = pickle.dumps({"format": "sed_tpu-aot-v1", "payload": _Trap()})
    with pytest.raises(ValueError, match="XLA executable.*sed_tpu_torch.cli.serve build"):
        ex.load_aot_pipeline(blob)
    assert UNPICKLED == []


def test_container_refuses_a_real_sed_tpu_artifact(fams):
    fam = fams["CnnAvgPooling"]
    blob = jex.aot_export_pipeline(*jex.cnn_serving(fam.flax, fam.params, fam.stats), B,
                                   SAMPLES, JCFG)
    with pytest.raises(ValueError, match="cannot run here"):
        ex.load_aot_pipeline(blob)


@pytest.mark.parametrize("case", ["not-a-zip", "no-header", "format"])
def test_container_refuses_what_is_not_an_artifact(blob, case):
    if case == "not-a-zip":
        bad = b"\x00" + blob[1:]
    elif case == "no-header":
        out = io.BytesIO()
        with zipfile.ZipFile(out, "w") as z:
            z.writestr("program.pt2", b"")
        bad = out.getvalue()
    else:
        bad = with_header(blob, format="sed_tpu-aot-v1")
    with pytest.raises(ValueError, match="not a sed_tpu_torch-aot-v1 artifact"):
        ex.load_aot_pipeline(bad)


def test_container_refuses_another_device_type(blob):
    with pytest.raises(ValueError, match="traced on cuda and runs only there"):
        ex.load_aot_pipeline(with_header(blob, device_type="cuda"), device="cpu")
    with pytest.raises(ValueError, match="traced on cpu and runs only there"):
        ex.load_aot_pipeline(blob, device="meta")


def test_container_needs_a_card_for_a_cuda_artifact(blob):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.load_aot_pipeline(with_header(blob, device_type="cuda"))


def test_container_refuses_a_library_of_another_source(blob):
    lib = {"name": "libsed_featurizer_000000000000.so", "digest": "000000000000",
           "sha256": "0" * 64, "bytes": 0}
    with pytest.raises(ValueError, match="another featurizer.cu"):
        ex.load_aot_pipeline(with_header(blob, kernel_library=lib))


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """An empty ``_build/`` and an ``nvcc`` that fails the test if called."""
    def no_nvcc():
        raise AssertionError("nvcc ran")

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    return tmp_path / "_build"


def test_library_install_needs_no_nvcc(build_dir):
    """The artifact's library bytes go into an empty ``_build/`` under
    build()'s own name (a temporary file renamed); build() then finds it
    and runs no nvcc.  Bytes of another source or with a wrong sha256 are
    refused, and an installed library is never overwritten."""
    import hashlib

    data = b"\x7fELF a library built from this featurizer.cu"
    digest, sha = kernels.library_digest(), hashlib.sha256(data).hexdigest()
    with pytest.raises(ValueError, match="another featurizer.cu"):
        kernels.install_library(data, "000000000000", sha)
    with pytest.raises(ValueError, match="sha256"):
        kernels.install_library(data, digest, "0" * 64)
    assert not build_dir.exists()
    path = kernels.install_library(data, digest, sha)
    assert path == kernels.library_path() and path.parent == build_dir
    assert path.read_bytes() == data and sorted(p.name for p in build_dir.iterdir()) == [path.name]
    info = kernels.build()
    assert info.path == path and info.seconds == 0.0
    other = b"\x7fELF another build"
    kernels.install_library(other, digest, hashlib.sha256(other).hexdigest())
    assert path.read_bytes() == data


def test_build_runs_the_recipe_that_names_the_library(build_dir, monkeypatch):
    """build() compiles each unit of ``BUILD_RECIPE`` with its compile flags
    and links the objects with its link flags, and the library's digest
    changes with every part of that recipe, so a changed recipe is never
    served a library built by the old one (nor installed from an artifact)."""
    import subprocess
    from pathlib import Path
    from types import SimpleNamespace

    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)

        def communicate(self):
            return "", None

    def run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(subprocess, "run", run)
    recipe = dict(kernels.BUILD_RECIPE)
    info = kernels.build()
    assert info.path == kernels.library_path() and info.path.read_bytes() == b"\x7fELF"
    *compiles, link = calls
    assert [c[1:1 + len(recipe["compile"]) + 1] for c in compiles] == [
        [*recipe["compile"], unit] for unit in recipe["units"]]
    objs = [c[c.index("-o") + 1] for c in compiles]
    assert link[1:1 + len(recipe["link"])] == list(recipe["link"]) and link[-len(objs):] == objs
    digest = kernels.library_digest()
    for key in recipe:
        monkeypatch.setitem(kernels.BUILD_RECIPE, key, recipe[key] + ("-DOTHER",))
        assert kernels.library_digest() != digest, key
        monkeypatch.setitem(kernels.BUILD_RECIPE, key, recipe[key])
    assert kernels.library_digest() == digest


def test_loader_installs_the_library_of_a_cuda_artifact(blob, build_dir, monkeypatch):
    """Through the loader: a CUDA artifact's library lands in ``_build/``
    before the loader reaches the card, with no nvcc (the CPU stands in for
    the card, and the load stops there: the library is never loaded here)."""
    import hashlib

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    data = b"\x7fELF a library"
    name = kernels.library_path().name
    lib = {"name": name, "digest": kernels.library_digest(),
           "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    src = zipfile.ZipFile(io.BytesIO(with_header(blob, device_type="cuda", kernel_library=lib)))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        for n in src.namelist():
            z.writestr(n, src.read(n))
        z.writestr(name, data)
    monkeypatch.setattr(ex, "resolve_device", torch.device)
    monkeypatch.setattr(torch, "empty", stop)
    with pytest.raises(Stop):
        ex.load_aot_fn(out.getvalue())
    assert (build_dir / name).read_bytes() == data


def test_export_refuses_mesh_fast_tiers_and_training_batch_norm(fams):
    """The fast and turbo tiers are ported (test_fast_tier_program_*); a tier
    that sed_tpu does not name is refused with its message, as is a training-
    mode batch norm."""
    head = ex.cnn_serving(fams["CnnAvgPooling"].port)
    with pytest.raises(ValueError, match="unknown featurizer precision tier 'fastest'"):
        ex.aot_export_pipeline(head, B, SAMPLES, CFG, featurizer_precision="fastest",
                               device="cpu")

    class TrainingNorm(torch.nn.Module):
        def forward(self, x):
            return F.batch_norm(x, None, None, training=True)

    with pytest.raises(ValueError, match="training-mode batch norm"):
        ex.aot_compile_fn(TrainingNorm(), torch.zeros(2, 3, 4))

"""bf16 training of the port (``cli/main.py --bf16``) against sed_tpu's (CPU).

``sed_tpu`` trains CnnAvgPooling and M5 with ``dtype=jnp.bfloat16``: the
convolutions and dense layers compute in bfloat16 while parameters,
optimizer state and BatchNorm statistics stay float32, and the logits
return as float32, so the loss (``sed_tpu/train/loss.py:37`` casts the
targets to the logits' dtype), augmentation and metrics stay float32.  The
port's ``dtype=torch.bfloat16`` does the same.

One bf16 train step from the same weights and batch: the train-mode logits
within 0.15 of sed_tpu's (its band for the tier, tests/test_models.py:166;
measured 3.9e-3 for CnnAvgPooling, 7.8e-3 for M5), the loss within 5e-3
relative (measured 2.7e-4 and 1.2e-3 on these inputs: the two bf16
forwards round their convolutions' sums in different orders).  After the
step every parameter, optimizer moment and BatchNorm statistic is float32,
and so is every tensor of the saved checkpoint.  ``cli.main --bf16`` trains
and checkpoints both archs on the synthetic FilmClap fixture of
tests/test_cli.py, and MobileNetV1 refuses it with sed_tpu's error.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_loop import _cli_args, film_clap_root  # noqa: F401 - a fixture
from test_torch_train_step import SMALL, _Store, np_tree
from test_torch_waveform_train import corpus, datasets  # noqa: F401 - a fixture
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data import device_pipeline as jax_pipe
from sed_tpu.models import cnn as jax_cnn
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.train import optim as jax_optim
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.cli import main as cli_main
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.models import cnn
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict, m5_state_dict
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.train.checkpoint import save_checkpoint
from sed_tpu_torch.train.state import init_state

CFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
JCFG = JaxSpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
JWCFG = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33)
LOGIT_BAND = 0.15
LOSS_RTOL = 5e-3
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spectrogram_case():
    """sed_tpu's bf16 CnnAvgPooling state, its step and inputs, and the
    port's bf16 model with the same weights: (jmodel, jstate, jstep, jbatch,
    port, step, bufs, starts, x)."""
    store = _Store(False, seed=4)
    bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    jbufs = jax_pipe.spectrogram_buffers_from_dataset(store)
    starts = store.train_start_indices[:8]
    jmodel = jax_cnn.CnnAvgPooling(classes_num=2, model_config=SMALL, dtype=jnp.bfloat16)
    tx = jax_optim.make_optimizer(LR)
    sample = jnp.zeros((8, CFG.train_crop_size, CFG.mel_bins, 1))
    jstate = jax_init_state(jmodel, jax.random.key(0), sample, tx)
    port = cnn.CnnAvgPooling(2, SMALL, dtype=torch.bfloat16)
    port.load_state_dict(cnn_avg_pooling_state_dict(np_tree(jstate.params),
                                                    np_tree(jstate.batch_stats)))
    f, _ = pipe.make_gather_crops(CFG)(bufs, torch.from_numpy(starts))
    x = pipe.make_transform(CFG, "logMel")(bufs, f)
    jf, _ = jax_pipe.make_gather_crops(JCFG)(jbufs, jnp.asarray(starts))
    jx = jnp.transpose(jax_pipe.make_transform(JCFG, "logMel")(jbufs, jf), (0, 2, 3, 1))
    jstep = jax_pipe.make_spectrogram_train_step(jmodel, tx, JCFG, 5.0, "logMel", augment=False)
    step = pipe.make_spectrogram_train_step(CFG, 5.0, "logMel", augment=False)
    return jmodel, jstate, jstep, (jbufs, jx), port, step, bufs, starts, x


def waveform_case(items):
    """The same for M5 on tests/test_data.py's corpus."""
    a, b = datasets(items)
    bufs = pipe.waveform_buffers_from_dataset(a, "cpu")
    jbufs = jax_pipe.waveform_buffers_from_dataset(b)
    starts = a.possible_start_indices[:8]
    jmodel = FlaxM5(classes_num=1, conv1_s2d=False, dtype=jnp.bfloat16)
    tx = jax_optim.make_optimizer(LR)
    sample = jnp.zeros((8, WCFG.frame_size, 1), jnp.float32)
    jstate = jax_init_state(jmodel, jax.random.key(0), sample, tx)
    port = M5(1, dtype=torch.bfloat16)
    port.load_state_dict(m5_state_dict(np_tree(jstate.params), np_tree(jstate.batch_stats)))
    waves, _ = pipe.make_waveform_gather(WCFG)(bufs, torch.from_numpy(starts))
    jx = jnp.asarray(waves.numpy().transpose(0, 2, 1))
    jstep = jax_pipe.make_waveform_train_step(jmodel, tx, JWCFG, 5.0, augment=False)
    step = pipe.make_waveform_train_step(WCFG, 5.0, augment=False)
    return jmodel, jstate, jstep, (jbufs, jx), port, step, bufs, starts, waves


def assert_float32_state(state, what):
    assert state.model.dtype == torch.bfloat16, what
    for key, t in state.model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, (what, key, t.dtype)
    moments = [v for s in state.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.is_floating_point() and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments), what
    assert len(state.optimizer.state) == len(list(state.model.parameters()))


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "M5"])
def test_one_bf16_step_follows_sed_tpu(arch, corpus, tmp_path):  # noqa: F811 - fixture
    """Train-mode logits within 0.15 of sed_tpu's bf16 forward, the step's
    loss within 5e-3 relative of sed_tpu's bf16 step, and float32 state and
    checkpoint after it."""
    jmodel, jstate, jstep, (jbufs, jx), port, step, bufs, starts, x = (
        spectrogram_case() if arch == "CnnAvgPooling" else waveform_case(corpus))
    jlogits, _ = jmodel.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                              jx, train=True, mutable=["batch_stats"])
    assert jlogits.dtype == jnp.float32   # the bf16 logits return as float32
    state = init_state(port, LR, "cpu")
    state.model.train()
    with torch.no_grad():
        logits = state.model(x)
    state.model.load_state_dict(port.state_dict())   # undo the statistics update
    assert logits.dtype == torch.float32
    theirs = np.asarray(jlogits.astype(jnp.float32)).reshape(logits.shape)
    logit_dev = float(np.abs(logits.numpy() - theirs).max())

    jstate, jloss = jstep(jstate, jbufs, jnp.asarray(starts), jax.random.key(1))
    loss = float(step(state, bufs, starts))
    print(f"{arch} bf16 step: logits port vs sed_tpu {logit_dev:.3e}; loss {loss} vs "
          f"{float(jloss)} (rel {abs(loss - float(jloss)) / abs(float(jloss)):.3e})")
    assert logit_dev <= LOGIT_BAND
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    assert state.step == 1
    assert_float32_state(state, arch)
    ckpt = torch.load(save_checkpoint(state, str(tmp_path / "run"), 1), weights_only=True)
    tensors = list(ckpt["model"].values()) + [
        v for s in ckpt["optimizer"]["state"].values() for v in s.values()]
    assert all(t.dtype == torch.float32 for t in tensors
               if torch.is_tensor(t) and t.is_floating_point() and t.dim() > 0)


@pytest.mark.parametrize("features", ["Spectogram", "Waveform"])
def test_train_cli_bf16_trains_and_checkpoints(features, film_clap_root, tmp_path):  # noqa: F811
    """``cli.main --bf16`` trains CnnAvgPooling (logMel) or M5 for four steps
    on the synthetic FilmClap fixture and writes float32 checkpoints that
    load into the float32 model; the metrics are finite."""
    out = tmp_path / "runs"
    argv = _cli_args(film_clap_root, str(out), "--train_features", features, "--bf16",
                     "--num_train_steps", "4", "--no_plot")
    cli_main.main(argv)
    (run,) = os.listdir(out)
    ckpts = sorted(os.listdir(out / run / "checkpoints"))
    assert ckpts == ["iteration_2.pt", "iteration_4.pt"]
    ckpt = torch.load(out / run / "checkpoints" / "iteration_4.pt", weights_only=True)
    assert ckpt["step"] == 4
    assert all(t.dtype == torch.float32 for t in ckpt["model"].values()
               if t.is_floating_point())
    model = (cnn.CnnAvgPooling(1, cnn.TRAIN_CHANNEL_AND_POOL) if features == "Spectogram"
             else M5(1))
    model.load_state_dict(ckpt["model"], strict=True)
    lines = (out / run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all(np.isfinite(float(v)) for v in
                                   __import__("json").loads(lines[-1]).values()
                                   if isinstance(v, float))


def copy_film_clap(src, dst):
    """A copy of a FilmClap root whose label file names the copied WAVs, so
    a run's preprocessed features land under ``dst`` alone."""
    import json
    import shutil

    with open(os.path.join(src, "FilmClap", "paths_and_labels_fixed_Meron.txt")) as f:
        labels = json.load(f)
    film = dst / "FilmClap" / "filmA"
    film.mkdir(parents=True)
    copied = {}
    for path, centers in labels.items():
        copied[str(film / os.path.basename(path))] = centers
        shutil.copy(path, film)
    with open(dst / "FilmClap" / "paths_and_labels_fixed_Meron.txt", "w") as f:
        json.dump(copied, f)
    return str(dst)


def test_train_cli_refuses_bf16_for_mobilenet_with_sed_tpus_error(film_clap_root,  # noqa: F811
                                                                   tmp_path):
    """MobileNetV1 with ``--bf16`` raises sed_tpu's ValueError: the port
    before any work, sed_tpu after preprocessing (on its own copy of the
    fixture)."""
    from sed_tpu.cli import main as jax_cli_main

    errors = []
    for main, sub in ((cli_main.main, "ours"), (jax_cli_main.main, "theirs")):
        root = film_clap_root if sub == "ours" else copy_film_clap(film_clap_root,
                                                                   tmp_path / "data")
        argv = _cli_args(root, str(tmp_path / sub), "--model", "MobileNetV1", "--bf16",
                         "--num_train_steps", "2")
        if sub == "ours":
            argv.append("--no_plot")
        with pytest.raises(ValueError) as exc:
            main(argv)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] == "--bf16 is implemented for CnnAvgPooling only"
    assert not (tmp_path / "ours").exists()


def test_batch_evaluator_takes_the_bf16_model():
    """``make_batch_evaluator`` with the bf16 CnnAvgPooling: float32 scores,
    losses and APs; scores within 0.05 of the float32 model's (measured
    4.0e-3), losses within 5e-2 relative (measured 9.3e-3: the weighted BCE
    of 8 frames a clip), and its scores equal the bf16 model's batch
    predictor (the same forward)."""
    from sed_tpu_torch.inference import make_batch_evaluator, make_batch_predictor

    f32 = cnn.CnnAvgPooling(1, cnn.TRAIN_CHANNEL_AND_POOL)
    f32.reset_parameters(torch.Generator().manual_seed(2))
    b16 = cnn.CnnAvgPooling(1, cnn.TRAIN_CHANNEL_AND_POOL, dtype=torch.bfloat16)
    b16.load_state_dict(f32.state_dict())
    rng = np.random.default_rng(2)
    clips = (3000 * rng.standard_normal((2, 4 * CFG.working_sample_rate, 1))).astype(np.int16)
    targets = (rng.random((2, 16, 1)) > 0.7).astype(np.float32)
    out = {}
    for tier, m in (("f32", f32), ("bf16", b16)):
        out[tier] = make_batch_evaluator(m, CFG, device="cpu")(clips, targets)
    scores, losses, _, _, aps = out["bf16"]
    assert scores.dtype == losses.dtype == aps.dtype == torch.float32
    np.testing.assert_allclose(scores.numpy(), out["f32"][0].numpy(), rtol=0, atol=0.05)
    np.testing.assert_allclose(losses.numpy(), out["f32"][1].numpy(), rtol=5e-2)
    assert float((scores - out["f32"][0]).abs().max()) > 0
    want = make_batch_predictor(b16, CFG, device="cpu")(clips)[:, :scores.shape[1]]
    np.testing.assert_array_equal(scores.numpy(), want.numpy())

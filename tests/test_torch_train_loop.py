"""The port's train loop, evaluation, checkpoints, training CLI and batch
evaluator against sed_tpu's, on the CPU.

Tolerances: train()'s per-step losses within 1e-5 relative of sed_tpu's
from the same initial weights and batches (no augmentation); evaluate()'s
losses within 1e-5 relative, APs within 1e-6 and the event and segment
metrics equal; make_batch_evaluator's scores within 1e-5 and its losses
within 1e-5 relative; checkpoint round trips and resume exact on the CPU
(atol 1e-7).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.data import spectrogram_dataset as jax_ds
from sed_tpu.data.preprocess import preprocess_data as jax_preprocess_data
from sed_tpu.models import cnn as jax_cnn
from sed_tpu.train import loop as jax_loop
from sed_tpu.train.optim import make_optimizer as jax_make_optimizer
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.cli import main as cli_main
from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.data import spectrogram_dataset as ds
from sed_tpu_torch.models import cnn
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.train import checkpoint, loop
from sed_tpu_torch.train.state import init_state

CFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
JCFG = JaxSpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
SMALL = ((8, 2), (16, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """tests/test_data.py's corpus (six 15 s wavs at 8 kHz, one 800 Hz event
    each, here late enough that crops hold it), preprocessed by sed_tpu; both
    packages' datasets read these pickles."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    items = []
    for i in range(6):
        sr = CFG.working_sample_rate
        sig = 0.01 * rng.standard_normal(15 * sr)
        start = 10.5 + 0.5 * (i % 3)
        t = np.arange(sr) / sr
        sig[int(start * sr):int(start * sr) + sr] += 0.5 * np.sin(2 * np.pi * 800 * t)
        path = str(root / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        items.append((path, np.array([start]), np.array([start + 1.0]), f"clip_{i}"))
    features_dir = str(root / "features")
    mean_std = str(root / "mean_std.pkl")
    jax_preprocess_data(items, features_dir, mean_std, preprocess_mode="logMel", cfg=JCFG,
                        plot_sample=False)
    return features_dir, mean_std


def datasets(features, seed=0):
    a = ds.SpectrogramDataset(*features, 0.34, preprocessed_mode="logMel", cfg=CFG, seed=seed)
    b = jax_ds.SpectrogramDataset(*features, 0.34, preprocessed_mode="logMel", cfg=JCFG,
                                  seed=seed)
    return a, b


def flax_start(batch, seed=0, lr=1e-3):
    """sed_tpu's initial state as train() builds it, and the port's model
    holding the same weights."""
    model = jax_cnn.CnnAvgPooling(classes_num=1, model_config=SMALL)
    sample = jnp.zeros((batch, CFG.train_crop_size, CFG.mel_bins, 1), jnp.float32)
    jstate = jax_init_state(model, jax.random.key(seed), sample, jax_make_optimizer(lr))
    port = cnn.CnnAvgPooling(1, SMALL)
    port.load_state_dict(cnn_avg_pooling_state_dict(np_tree(jstate.params),
                                                    np_tree(jstate.batch_stats)))
    return model, jstate, port


def _recording_plotter(monkeypatch, module, cls, sink):
    class Recording(cls):
        def report_train_loss(self, value):
            sink.append(float(value))
            super().report_train_loss(value)

    monkeypatch.setattr(module, "ProgressPlotter", Recording)


# ---------------------------------------------------------------------------
# train() and evaluate()
# ---------------------------------------------------------------------------

def test_train_matches_sed_tpu_loop(features, tmp_path, monkeypatch):
    from sed_tpu.utils import progress as jax_progress
    from sed_tpu_torch.utils import progress

    a, b = datasets(features)
    batch, steps = 4, 6
    model, jstate, port = flax_start(batch)
    ours, theirs = [], []
    _recording_plotter(monkeypatch, loop, progress.ProgressPlotter, ours)
    _recording_plotter(monkeypatch, jax_loop, jax_progress.ProgressPlotter, theirs)
    state = loop.train(port, a, "spectogram", num_steps=steps, lr=1e-3, log_freq=3,
                       outputs_dir=str(tmp_path / "torch"), batch_size=batch, cfg=CFG,
                       initial_state=init_state(port, 1e-3, "cpu"), make_plots=False,
                       device="cpu")
    jax_loop.train(model, b, "spectogram", num_steps=steps, lr=1e-3, log_freq=3,
                   outputs_dir=str(tmp_path / "jax"), batch_size=batch, cfg=JCFG,
                   make_plots=False)
    assert len(ours) == len(theirs) == steps and state.step == steps
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    recs = [[json.loads(line) for line in open(tmp_path / tag / "metrics.jsonl")]
            for tag in ("torch", "jax")]
    assert [r["iteration"] for r in recs[0]] == [3, 6]
    for r, q in zip(*recs):
        assert set(r) == set(q)
        np.testing.assert_allclose(r["val_loss"], q["val_loss"], rtol=1e-5)
        np.testing.assert_allclose(r["train_loss"], q["train_loss"], rtol=1e-5)
    assert sorted(os.listdir(tmp_path / "torch" / "checkpoints")) == \
        ["iteration_3.pt", "iteration_6.pt"]


def test_evaluate_matches_sed_tpu(features, tmp_path):
    a, b = datasets(features, seed=1)
    model, jstate, port = flax_start(4, seed=2)
    # Non-trivial BatchNorm statistics.
    g = torch.Generator().manual_seed(0)
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)
    sd = port.state_dict()
    bs = np_tree(jstate.batch_stats)
    for i in range(len(SMALL)):
        for j in range(2):
            bs[f"ConvBlock_{i}"][f"BatchNorm_{j}"] = {
                "mean": sd[f"conv_blocks.{i}.bn{j + 1}.running_mean"].numpy(),
                "var": sd[f"conv_blocks.{i}.bn{j + 1}.running_var"].numpy()}
    jstate = jstate.replace(batch_stats=bs)
    state = init_state(port, 1e-3, "cpu")
    got = loop.evaluate(port, state, a, "spectogram", 5.0, str(tmp_path), 0,
                        make_plots=False, cfg=CFG)
    want = jax_loop.evaluate(model, jstate, b, "spectogram", 5.0, str(tmp_path), 0,
                             make_plots=False, cfg=JCFG)
    losses, recalls, precisions, aps, event_ms = got
    assert len(losses) == len(want[0]) == 2
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    np.testing.assert_allclose(aps, want[3], atol=1e-6)
    for r, q in zip(recalls, want[1]):
        np.testing.assert_allclose(r, q, atol=1e-6)
    for r, q in zip(precisions, want[2]):
        np.testing.assert_allclose(r, q, atol=1e-6)
    assert event_ms == want[4]


def test_evaluate_mixed_lengths_is_exact(tmp_path):
    """The bucketed exact forward equals the whole forward per recording."""
    lengths = [181, 175, 230, 169]

    class Mixed:
        def get_validation_sampler(self, max_validate_num=None):
            r = np.random.default_rng(7)
            for i, t in enumerate(lengths):
                vf = r.standard_normal((1, t, CFG.mel_bins)).astype(np.float32)
                ve = (r.random((t, 1)) > 0.8).astype(np.float32)
                yield vf[None], ve[None], f"val_{i}"

    port = cnn.CnnAvgPooling(1, ((9, 2), (11, 2)), generator=torch.Generator().manual_seed(0))
    state = init_state(port, 1e-3, "cpu")
    _, _, _, aps, event_ms = loop.evaluate(port, state, Mixed(), "spectogram", 5.0,
                                           str(tmp_path), 0, make_plots=False, cfg=None)
    assert event_ms == []
    from sed_tpu_torch.utils.metrics import calculate_metrics

    port.eval()
    for (vf, ve, _), ap in zip(Mixed().get_validation_sampler(), aps):
        with torch.no_grad():
            logits = port(torch.from_numpy(vf)).numpy()[0]
        scores = loop._sigmoid_np(logits)
        assert ap == pytest.approx(calculate_metrics(scores, ve[0])[2], abs=1e-9)


def test_evaluate_plots_best_and_worst(features, tmp_path):
    pytest.importorskip("matplotlib")
    a, _ = datasets(features)
    port = cnn.CnnAvgPooling(1, SMALL)
    loop.evaluate(port, init_state(port, 1e-3, "cpu"), a, "spectogram", 5.0,
                  str(tmp_path), 7, make_plots=True, cfg=CFG)
    assert sorted(os.listdir(tmp_path / "images" / "Iter-7")) == \
        ["AP-best.png", "AP-worst.png", "loss-2-worst.png", "loss-best.png", "loss-worst.png"]


def test_waveform_mode_and_unported_options_are_refused(features, tmp_path):
    """The waveform mode, steps_per_call, profile_dir and mesh are ported
    (their runs: tests/test_torch_waveform_train.py, test_torch_multi_step.py,
    test_torch_parallel.py); an unknown mode, a batch that does not divide
    over the mesh, steps_per_call that does not divide the run and a batch
    larger than the dataset are still refused before any step."""
    from sed_tpu_torch.parallel.mesh import Mesh

    a, _ = datasets(features)
    port = cnn.CnnAvgPooling(1, SMALL)
    with pytest.raises(ValueError, match="mode"):
        loop.train(port, a, "wave", 2, 1e-3, 2, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="global batch_size=4 must be divisible by the "
                                         "mesh size 3"):
        loop.train(port, a, "spectogram", 2, 1e-3, 2, str(tmp_path), batch_size=4,
                   mesh=Mesh(None, 3, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="multiples of steps_per_call"):
        loop.train(port, a, "spectogram", 6, 1e-3, 3, str(tmp_path), device="cpu",
                   steps_per_call=2)
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="batch_size"):
        loop.train(port, a, "spectogram", 2, 1e-3, 2, str(tmp_path), batch_size=10 ** 6,
                   device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints and resume
# ---------------------------------------------------------------------------

def _run_steps(state, bufs, starts_list, step):
    return [float(step(state, bufs, s)) for s in starts_list]


def test_checkpoint_round_trip(features, tmp_path):
    a, _ = datasets(features)
    bufs = pipe.spectrogram_buffers_from_dataset(a, "cpu")
    step = pipe.make_spectrogram_train_step(CFG)
    state = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=0)
    _run_steps(state, bufs, list(a.epoch_start_indices(4))[:3], step)
    path = checkpoint.save_checkpoint(state, str(tmp_path), 3)
    assert path == checkpoint.checkpoint_path(str(tmp_path), 3)
    assert path.endswith(os.path.join("checkpoints", "iteration_3.pt"))
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "scheduler", "step"} and ckpt["step"] == 3

    restored = checkpoint.load_checkpoint(
        path, init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=9))
    assert restored.step == 3 and restored.scheduler.last_epoch == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k
    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        for p, q in zip(state.model.parameters(), restored.model.parameters()):
            assert torch.equal(state.optimizer.state[p][k], restored.optimizer.state[q][k])

    fresh = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=9)
    model_only = checkpoint.load_checkpoint(path, fresh, model_only=True)
    assert model_only.step == 0 and not model_only.optimizer.state
    x = torch.randn(2, 1, 40, 64)
    for m in (state.model, model_only.model):
        m.eval()
    torch.testing.assert_close(state.model(x), model_only.model(x), atol=1e-7, rtol=0)


@pytest.mark.parametrize("suffix", [".ckpt.orbax", ".ckpt.orbax/"])
def test_sed_tpu_checkpoints_are_refused_by_name(tmp_path, suffix):
    """sed_tpu's orbax directories, once refused, load: the committed
    fixture (tests/torch_orbax_fixture.py), named with and without the
    trailing separator, restores as its msgpack twin does; a missing one
    raises, naming sed_tpu's layout."""
    golden = os.path.join(os.path.dirname(__file__), "golden", "torch_orbax")
    path = os.path.join(golden, "iteration_2" + suffix)
    got = checkpoint.load_checkpoint(path, init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu"))
    want = checkpoint.load_checkpoint(os.path.join(golden, "iteration_2.ckpt"),
                                      init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu"))
    assert got.step == want.step == 2
    for (k, v), w in zip(got.model.state_dict().items(), want.model.state_dict().values()):
        assert torch.equal(v, w), k
    template = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu")
    with pytest.raises(ValueError, match="not an orbax OCDBT checkpoint"):
        checkpoint.load_checkpoint(str(tmp_path / f"iteration_4{suffix}"), template)


def test_full_resume_matches_continuous_training(features, tmp_path):
    """As tests/test_train.py: 10 steps, against 5 steps, save, restore into
    a fresh template, 5 more (same batches)."""
    a, _ = datasets(features)
    bufs = pipe.spectrogram_buffers_from_dataset(a, "cpu")
    step = pipe.make_spectrogram_train_step(CFG, augment=False)
    batches = list(a.epoch_start_indices(4))[:10]
    assert len(batches) == 10
    cont = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=0)
    cont_losses = _run_steps(cont, bufs, batches, step)

    first = init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=0)
    _run_steps(first, bufs, batches[:5], step)
    path = checkpoint.save_checkpoint(first, str(tmp_path), 5)
    resumed = checkpoint.load_checkpoint(
        path, init_state(cnn.CnnAvgPooling(1, SMALL), 1e-3, "cpu", seed=42))
    resumed_losses = _run_steps(resumed, bufs, batches[5:], step)
    assert resumed.step == 10
    np.testing.assert_allclose(resumed_losses, cont_losses[5:], rtol=1e-6)
    for (k, v), w in zip(cont.model.state_dict().items(), resumed.model.state_dict().values()):
        assert (v.double() - w.double()).abs().max() <= 1e-7, k
    for p, q in zip(cont.model.parameters(), resumed.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
            assert (cont.optimizer.state[p][k] - resumed.optimizer.state[q][k]).abs().max() <= 1e-7
    assert resumed.optimizer.param_groups[0]["lr"] == cont.optimizer.param_groups[0]["lr"]


def test_latest_checkpoint_tie_break(tmp_path):
    ckpt_dir = tmp_path / "checkpoints"
    assert checkpoint.latest_checkpoint(str(tmp_path)) is None
    ckpt_dir.mkdir()
    for name, mtime in (("iteration_2.pt", 100), ("iteration_10.pt", 200),
                        ("iteration_010.pt", 300), ("iteration_x.pt", 400),
                        ("iteration_5.ckpt", 500), ("notes.txt", 600)):
        (ckpt_dir / name).write_bytes(b"")
        os.utime(ckpt_dir / name, (mtime, mtime))
    # Equal iteration counts: the most recently written wins; sed_tpu's
    # .ckpt files count by their iteration (5 loses to 10).
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(ckpt_dir / "iteration_010.pt")
    os.utime(ckpt_dir / "iteration_10.pt", (700, 700))
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(ckpt_dir / "iteration_10.pt")


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def film_clap_root(tmp_path_factory):
    """Synthetic FilmClap dataset: 4 x 12 s clips at 48 kHz with clap-like
    events (tests/test_cli.py's fixture)."""
    root = tmp_path_factory.mktemp("data")
    film_dir = root / "FilmClap" / "filmA"
    film_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    labels = {}
    sr = DEFAULT_SPECTROGRAM.working_sample_rate
    for i in range(4):
        n = 12 * sr
        sig = 0.01 * rng.standard_normal(n)
        center = 5.0 + 0.5 * i
        click = np.exp(-np.linspace(0, 40, int(0.1 * sr)))
        start = int(center * sr)
        sig[start:start + len(click)] += 0.8 * click * np.sin(
            2 * np.pi * 3000 * np.arange(len(click)) / sr)
        path = str(film_dir / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        labels[path] = [center]
    with open(root / "FilmClap" / "paths_and_labels_fixed_Meron.txt", "w") as f:
        json.dump(labels, f)
    return str(root)


def _cli_args(root, outputs_root, *extra):
    return ["--dataset_dir", root, "--dataset_name", "FilmClap",
            "--train_features", "Spectogram", "--outputs_root", outputs_root,
            "--val_descriptor", "clip_3", "--batch_size", "4", "--log_freq", "2",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("arch,mode", [("CnnAvgPooling", "logMel"),
                                       ("CnnAvgPooling", "Complex"),
                                       ("MobileNetV1", "logMel"),
                                       ("MobileNetV1", "Complex")])
def test_train_cli_end_to_end(film_clap_root, tmp_path, arch, mode):
    """Train through the CLI, then score a file with the port's cli.infer
    from the checkpoint (as tests/test_cli.py does for sed_tpu)."""
    from sed_tpu_torch.cli.infer import main as infer_main

    plots = arch == "CnnAvgPooling" and mode == "logMel"
    if plots:
        pytest.importorskip("matplotlib")
    outputs_root = str(tmp_path / "training")
    extra = ["--model", arch, "--preprocess_mode", mode, "--num_train_steps", "4"]
    if mode == "Complex":
        extra.append("--augment_data")
    cli_main.main(_cli_args(film_clap_root, outputs_root, *extra,
                            *([] if plots else ["--no_plot"])))
    (run_dir,) = [os.path.join(outputs_root, d) for d in os.listdir(outputs_root)]
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == \
        ["iteration_2.pt", "iteration_4.pt"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records] == [2, 4]
    assert {"iteration", "train_loss", "val_loss", "AP", "max_f1", "max_f5",
            "event_f1", "segment_error_rate", "macro_AP"} <= set(records[0])
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)
    assert os.path.exists(os.path.join(run_dir, "Training_loss.png")) == plots
    assert (f"{mode}-" in run_dir) and (("MobileNetV1" in run_dir) == (arch == "MobileNetV1"))
    assert run_dir.endswith("_AD") == (mode == "Complex")

    wav = sorted(json.load(open(os.path.join(
        film_clap_root, "FilmClap", "paths_and_labels_fixed_Meron.txt"))))[0]
    out_dir = str(tmp_path / "inference")
    infer_main([wav, "--ckpt", os.path.join(run_dir, "checkpoints", "iteration_4.pt"),
                "--outputs_dir", out_dir, "--device", "cpu", "--no_plot", "--arch", arch])
    base = os.path.splitext(os.path.basename(wav))[0]
    scores = np.load(os.path.join(out_dir, f"{base}_scores.npy"))
    # 12 s * 3 fps + 1 = 37 frames -> 8 * floor(37 / 8) = 32 frames.
    assert scores.shape == (32, 1)
    assert ((scores >= 0) & (scores <= 1)).all()


def test_train_cli_resume_auto(film_clap_root, tmp_path):
    outputs_root = str(tmp_path / "training")
    cli_main.main(_cli_args(film_clap_root, outputs_root, "--num_train_steps", "2", "--no_plot"))
    (run_dir,) = [os.path.join(outputs_root, d) for d in os.listdir(outputs_root)]
    first = torch.load(os.path.join(run_dir, "checkpoints", "iteration_2.pt"),
                       weights_only=True)
    cli_main.main(_cli_args(film_clap_root, outputs_root, "--num_train_steps", "4",
                            "--resume", "auto", "--no_plot"))
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == \
        ["iteration_2.pt", "iteration_4.pt"]
    second = torch.load(os.path.join(run_dir, "checkpoints", "iteration_4.pt"),
                        weights_only=True)
    assert second["step"] == 4 and second["scheduler"]["last_epoch"] == 4
    # The optimizer's moments carried over: step counts 4, not 2.
    assert int(second["optimizer"]["state"][0]["step"]) == 4
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["iteration"] for line in f] == [2, 4]
    # --ckpt restores the weights only.
    cli_main.main(_cli_args(film_clap_root, str(tmp_path / "again"), "--num_train_steps", "2",
                            "--no_plot", "--ckpt",
                            os.path.join(run_dir, "checkpoints", "iteration_2.pt")))
    (again,) = os.listdir(tmp_path / "again")
    third = torch.load(tmp_path / "again" / again / "checkpoints" / "iteration_2.pt",
                       weights_only=True)
    assert int(third["optimizer"]["state"][0]["step"]) == 2
    assert not torch.equal(third["model"]["event_fc.weight"], first["model"]["event_fc.weight"])


PORTED_FLAGS = {"--train_features Waveform", "--steps_per_call > 1", "--profile_dir",
                "--bf16", "--preprocess_workers > 0", "--num_devices > 1"}


@pytest.mark.parametrize("flags,name", [
    (["--train_features", "Waveform"], "--train_features Waveform"),
    (["--steps_per_call", "4"], "--steps_per_call > 1"),
    (["--num_devices", "2"], "--num_devices > 1"),
    (["--bf16"], "--bf16"),
    (["--profile_dir", "prof"], "--profile_dir"),
    (["--preprocess_workers", "2"], "--preprocess_workers > 0"),
])
def test_train_cli_refuses_unported_flags(tmp_path, capsys, flags, name):
    """The flags still unported are refused by name before any work; the
    six that are ported now (the Waveform features, steps_per_call,
    profile_dir, bf16, preprocess_workers and num_devices on the CPU's gloo
    ranks) pass the check (their runs: tests/test_torch_waveform_train.py,
    tests/test_torch_multi_step.py, tests/test_torch_bf16_train.py,
    tests/test_torch_native_io.py and tests/test_torch_parallel_cli.py)."""
    argv = ["--dataset_dir", str(tmp_path / "absent"), "--train_features", "Spectogram",
            "--device", "cpu", "--no_plot", *flags]
    if name in PORTED_FLAGS:
        parser = cli_main.build_arg_parser()
        cli_main.refuse_unported(parser, parser.parse_args(argv))
        assert not capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as e:
        cli_main.main(argv)
    assert e.value.code == 2
    assert name in capsys.readouterr().err
    assert not os.listdir(tmp_path)   # refused before any work


def test_train_cli_refuses_plots_without_matplotlib(tmp_path, capsys, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(SystemExit):
        cli_main.main(["--dataset_dir", str(tmp_path), "--train_features", "Spectogram",
                       "--device", "cpu"])
    assert "--no_plot" in capsys.readouterr().err


def test_train_cli_defaults():
    args = cli_main.build_arg_parser().parse_args([])
    assert args.device == "cuda" and args.batch_size == 128 and args.lr == 1e-6
    assert cli_main.parse_val_descriptor("0.25") == 0.25
    assert cli_main.parse_val_descriptor("clip_3") == "clip_3"


# ---------------------------------------------------------------------------
# make_batch_evaluator
# ---------------------------------------------------------------------------

def test_batch_evaluator_matches_sed_tpu():
    from sed_tpu.inference import make_batch_evaluator as jax_make_batch_evaluator
    from sed_tpu_torch.inference import make_batch_evaluator

    rng = np.random.default_rng(4)
    batch, seconds = 3, 14
    sr = CFG.working_sample_rate
    t = np.arange(seconds * sr) / sr
    waves = 0.1 * rng.standard_normal((batch, seconds * sr, 1))
    waves[1, :, 0] += 0.4 * np.sin(2 * np.pi * 900 * t) * (t % 4 < 1)
    waves = waves.astype(np.float32)
    frames = 1 + seconds * sr // CFG.hop_size
    out_frames = 4 * (frames // 4)
    targets = (rng.random((batch, out_frames, 1)) > 0.7).astype(np.float32)
    mean = rng.uniform(-60, -40, CFG.mel_bins).astype(np.float32)
    std = rng.uniform(5, 15, CFG.mel_bins).astype(np.float32)
    model, jstate, port = flax_start(batch, seed=5)
    j = jax_make_batch_evaluator(model, JCFG, mean=mean, std=std, pos_weight=5.0)(
        jstate.params, jstate.batch_stats, jnp.asarray(waves), jnp.asarray(targets))
    got = make_batch_evaluator(port, CFG, mean=mean, std=std, pos_weight=5.0,
                               device="cpu")(waves, targets)
    scores, losses, recalls, precisions, aps = (x.numpy() for x in got)
    assert scores.shape == np.asarray(j[0]).shape == (batch, out_frames, 1)
    assert np.abs(scores - np.asarray(j[0])).max() <= 1e-5
    np.testing.assert_allclose(losses, np.asarray(j[1]), rtol=1e-5)
    np.testing.assert_allclose(recalls, np.asarray(j[2]), atol=1e-6)
    np.testing.assert_allclose(precisions, np.asarray(j[3]), atol=1e-6)
    np.testing.assert_allclose(aps, np.asarray(j[4]), atol=1e-6)
    with pytest.raises(ValueError, match="logits"):
        make_batch_evaluator(cnn.MobileNetV1(1), CFG, device="cpu")

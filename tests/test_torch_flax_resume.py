"""A full resume of ``sed_tpu``'s msgpack ``.ckpt`` in the port
(``train/checkpoint.load_checkpoint``, ``latest_checkpoint``, ``cli/main.py
--resume auto`` and ``--ckpt``) against ``sed_tpu``'s resume of the same
file, on the CPU.

For each arch ``sed_tpu`` trains N = 3 float32 steps at a small width (batch
8, lr 1e-5, seeded BatchNorm affines) and saves ``iteration_3.ckpt``; then
``sed_tpu`` and the port each resume from it for K = 3 steps on the same
batches.  The restored state is ``sed_tpu``'s bit for bit (weights,
statistics, the AMSGrad moments and counts, the schedule's lr).  After the
K steps: losses within rtol 1e-5 (test_train_matches_sed_tpu_loop's), and
parameters, BatchNorm statistics and moments within the bounds of
``TOLS``, set from what these float32 steps measure (the two packages'
gradients part at float32 rounding, which Adam turns into lr-sized moves
where a gradient is near zero): CnnAvgPooling 7.2e-7 (parameters) and
6.6e-6 (moments, of each tensor's largest); M5 3.3e-6 and 5.3e-6 with its
conv biases aside (each feeds a BatchNorm, so their gradients are rounding
noise and Adam moves them by up to lr a step: bounded by 2 K lr);
MobileNetV1 1.1e-5 and 0.106 (at 30 frames its deep 1 x 1 layers' float32
gradients lie ~1% from float64 in both packages,
tests/test_torch_train_step.py).

The port's own ``.pt`` of a state and the ``.ckpt`` that
``tests/torch_flax_ckpt.py`` writes of it resume to the same float64 steps
(the check chip_smoke.py makes on the card), and ``sed_tpu`` restores that
``.ckpt`` to the state it came from.
"""

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import torch_flax_ckpt as writer
from sed_tpu.cli import main as jax_cli_main
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.data import device_pipeline as jax_pipe
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.train import checkpoint as jax_checkpoint
from sed_tpu.train.optim import make_optimizer as jax_make_optimizer
from sed_tpu.train.optim import reference_lr_schedule
from sed_tpu.train.state import init_state as jax_init_state
from sed_tpu_torch.cli import main as cli_main
from sed_tpu_torch.configs import DEFAULT_WAVEFORM, SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.models.cnn import CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import FLAX_CONVERTERS
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.train import checkpoint
from sed_tpu_torch.train.state import init_state

ARCHS = ("CnnAvgPooling", "MobileNetV1", "M5")
SMALL = ((8, 2), (16, 2))
LR, N, K, B = 1e-5, 3, 3, 8
JCFG, CFG = JaxSpectrogramConfig(), SpectrogramConfig()
JWCFG = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33)
WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
LOSS_RTOL = 1e-5
# arch -> (parameters and statistics, atol; moments, of each tensor's largest).
TOLS = {"CnnAvgPooling": (1e-5, 1e-4), "M5": (2e-5, 1e-4), "MobileNetV1": (1e-4, 0.2)}
CONV_BIASES = (".0.bias", ".3.bias")
MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "nu_max": "max_exp_avg_sq"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(arch):
    return {"CnnAvgPooling": lambda: CnnAvgPooling(1, SMALL),
            "MobileNetV1": lambda: MobileNetV1(1, emit="logits"),
            "M5": lambda: M5(1)}[arch]()


class Arch:
    """``arch``'s flax module, jitted sed_tpu step, port step, both
    packages' buffers and the batches' start indices (N + K rows of B)."""

    def __init__(self, arch, lr=LR):
        self.arch, self.lr = arch, lr
        rng = np.random.default_rng(0)
        if arch == "M5":
            self.flax = FlaxM5(classes_num=1)
            self.sample = jnp.zeros((B, JWCFG.frame_size, 1))
            total = 6 * JWCFG.frame_size
            wave = (0.1 * rng.standard_normal((1, total))).astype(np.float32)
            labels = (rng.random(total) > 0.8).astype(np.float32)
            self.jbufs = jax_pipe.WaveformBuffers(
                waveform=jnp.asarray(wave), labels=jnp.asarray(labels),
                start_indices=jnp.arange(total - JWCFG.frame_size, dtype=jnp.int32))
            self.bufs = lambda dtype: pipe.WaveformBuffers(
                waveform=torch.from_numpy(wave).to(dtype), labels=torch.from_numpy(labels),
                start_indices=torch.arange(total - WCFG.frame_size))
            self.jstep = jax_pipe.make_waveform_train_step(
                self.flax, jax_make_optimizer(lr), JWCFG, 5.0, False)
            self.step = pipe.make_waveform_train_step(WCFG, 5.0, False)
            high = total - JWCFG.frame_size
        else:
            self.flax = (FlaxCnn(classes_num=1, model_config=SMALL) if arch == "CnnAvgPooling"
                         else FlaxMobileNetV1(classes_num=1, emit="logits"))
            crop, mel = JCFG.train_crop_size, JCFG.mel_bins
            self.sample = jnp.zeros((B, crop, mel, 1))
            total = 6 * crop
            feats = rng.standard_normal((1, total, mel)).astype(np.float32)
            events = (rng.random((total, 1)) > 0.8).astype(np.float32)
            self.jbufs = jax_pipe.SpectrogramBuffers(
                features=jnp.asarray(feats), events=jnp.asarray(events),
                start_indices=jnp.arange(total - crop, dtype=jnp.int32),
                mean=jnp.zeros((mel,)), std=jnp.ones((mel,)))
            self.bufs = lambda dtype: pipe.SpectrogramBuffers(
                features=torch.from_numpy(feats).to(dtype), events=torch.from_numpy(events),
                start_indices=torch.arange(total - crop), mean=torch.zeros(mel, dtype=dtype),
                std=torch.ones(mel, dtype=dtype))
            self.jstep = jax_pipe.make_spectrogram_train_step(
                self.flax, jax_make_optimizer(lr), JCFG, 5.0, "logMel", False)
            self.step = pipe.make_spectrogram_train_step(CFG, 5.0, "logMel", False)
            high = total - crop
        self.starts = np.random.default_rng(1).integers(0, high, size=(N + K, B)) \
            .astype(np.int32)

    def template(self):
        return jax_init_state(self.flax, jax.random.key(5), self.sample,
                              jax_make_optimizer(self.lr))

    def jax_steps(self, state, rows):
        losses = []
        for i in rows:
            state, loss = self.jstep(state, self.jbufs, jnp.asarray(self.starts[i]),
                                     jax.random.key(1))
            losses.append(float(loss))
        return state, losses

    def port_steps(self, state, rows, dtype=torch.float32):
        bufs = self.bufs(dtype)
        return [float(self.step(state, bufs, self.starts[i])) for i in rows]


def seeded_start(a: Arch):
    """sed_tpu's init of ``a`` with seeded BatchNorm scales and biases."""
    state = jax_init_state(a.flax, jax.random.key(0), a.sample, jax_make_optimizer(LR))
    rng = np.random.default_rng(11)

    def draw(path, x):
        lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3)}.get(path[-1].key, (None, None))
        x = np.asarray(x)
        return x if lo is None else rng.uniform(lo, hi, x.shape).astype(np.float32)

    return state.replace(params=jax.tree_util.tree_map_with_path(draw, state.params))


@pytest.fixture(scope="module", params=ARCHS)
def trained(request, tmp_path_factory):
    """sed_tpu's N steps and ``iteration_3.ckpt``, its own resume from it
    (restored state, K losses, final state)."""
    a = Arch(request.param)
    state, _ = a.jax_steps(seeded_start(a), range(N))
    path = jax_checkpoint.save_checkpoint(state, str(tmp_path_factory.mktemp(a.arch)), N)
    restored = jax_checkpoint.load_checkpoint(path, a.template())
    snapshot = np_tree(restored)
    final, losses = a.jax_steps(restored, range(N, N + K))
    return a, path, snapshot, losses, np_tree(final)


def flax_moments(arch, state):
    """The port's names -> each AMSGrad moment of ``state``'s (numpy) tree."""
    convert = FLAX_CONVERTERS[arch]
    amsgrad = state.opt_state[0]
    return {name: convert(getattr(amsgrad, key), state.batch_stats)
            for key, name in MOMENTS.items()}


def test_load_restores_sed_tpus_state_bit_for_bit(trained):
    """``load_checkpoint`` of the .ckpt: the weights and statistics, the
    three moments of every parameter and its step, each group's lr, the
    schedule's epoch and the step are what sed_tpu restores; MobileNetV1's
    ``bn0`` (no flax counterpart, never stepped) has no optimizer state."""
    a, path, want, _, _ = trained
    state = checkpoint.load_checkpoint(path, init_state(port_model(a.arch), LR, "cpu", seed=3))
    sd = state.model.state_dict()
    for key, value in FLAX_CONVERTERS[a.arch](want.params, want.batch_stats).items():
        if not key.startswith("bn0."):
            assert torch.equal(sd[key], value), key
    moments = flax_moments(a.arch, want)
    count = int(want.opt_state[0].count)
    assert count == N and int(want.opt_state[1].count) == N
    for name, p in state.model.named_parameters():
        if name.startswith("bn0."):
            assert p not in state.optimizer.state, name
            continue
        entry = state.optimizer.state[p]
        assert entry["step"].dtype == torch.float32 and float(entry["step"]) == count
        for moment, tree in moments.items():
            assert torch.equal(entry[moment], tree[name]), (name, moment)
    assert state.step == int(want.step) == N
    assert state.scheduler.last_epoch == N
    assert [g["lr"] for g in state.optimizer.param_groups] == [reference_lr_schedule(LR)(N)]


def test_resumed_steps_follow_sed_tpus_resume(trained):
    """K steps from the .ckpt in both packages on the same batches."""
    a, path, _, want_losses, want = trained
    tol, moment_tol = TOLS[a.arch]
    state = checkpoint.load_checkpoint(path, init_state(port_model(a.arch), LR, "cpu", seed=3))
    losses = a.port_steps(state, range(N, N + K))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    sd = state.model.state_dict()
    worst = 0.0
    for key, value in FLAX_CONVERTERS[a.arch](want.params, want.batch_stats).items():
        if key.startswith("bn0.") or key.endswith("num_batches_tracked"):
            continue
        err = float((sd[key] - value).abs().max())
        if a.arch == "M5" and key.endswith(CONV_BIASES):
            assert err <= 2 * K * LR, (key, err)
            continue
        worst = max(worst, err)
        assert err <= tol, (key, err)
    worst_moment = 0.0
    for moment, tree in flax_moments(a.arch, want).items():
        for name, p in state.model.named_parameters():
            if name.startswith("bn0.") or (a.arch == "M5" and name.endswith(CONV_BIASES)):
                continue
            ref = tree[name]
            err = float((state.optimizer.state[p][moment] - ref).abs().max()
                        / ref.abs().max())
            worst_moment = max(worst_moment, err)
            assert err <= moment_tol, (name, moment, err)
    print(f"{a.arch}: losses {np.abs(np.array(losses) / want_losses - 1).max():.3e}, "
          f"parameters {worst:.3e}, moments {worst_moment:.3e} of each tensor's largest")
    assert state.step == int(want.step) == N + K
    assert [g["lr"] for g in state.optimizer.param_groups] == [reference_lr_schedule(LR)(N + K)]


def test_a_step_on_the_schedule_boundary_resumes_with_the_decayed_lr(tmp_path):
    """sed_tpu's state at step 200 (both counts 200): the port resumes with
    lr 0.997 lr0 (lr0 1e-2 here, so that the 0.3% shows in float32
    updates), and its next update is sed_tpu's within 1e-3 of each
    element's (a full lr would miss by 3e-3)."""
    lr = 1e-2
    a = Arch("CnnAvgPooling", lr)
    state, _ = a.jax_steps(seeded_start(a), range(N))
    at = jnp.asarray(200, jnp.int32)
    amsgrad, schedule = state.opt_state
    state = state.replace(step=at, opt_state=(amsgrad._replace(count=at),
                                              schedule._replace(count=at)))
    path = jax_checkpoint.save_checkpoint(state, str(tmp_path), 200)
    jstate = jax_checkpoint.load_checkpoint(path, a.template())
    before = FLAX_CONVERTERS[a.arch](*np_tree((jstate.params, jstate.batch_stats)))
    jstate, want = a.jax_steps(jstate, [N])
    port = checkpoint.load_checkpoint(path, init_state(port_model(a.arch), lr, "cpu"))
    decayed = reference_lr_schedule(lr)(200)
    assert decayed == lr * 0.997
    assert [g["lr"] for g in port.optimizer.param_groups] == [decayed]
    assert port.scheduler.last_epoch == 200 and port.step == 200
    got = a.port_steps(port, [N])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    after = FLAX_CONVERTERS[a.arch](*np_tree((jstate.params, jstate.batch_stats)))
    sd = port.model.state_dict()
    worst = 0.0
    for key in (k for k, _ in port.model.named_parameters()):
        moved = after[key] - before[key]
        big = moved.abs() > 0.1 * decayed
        assert big.float().mean() > 0.5, key
        rel = ((sd[key] - before[key]) - moved)[big].abs() / moved[big].abs()
        worst = max(worst, float(rel.max()))
    print(f"the update at step 200, port vs sed_tpu: {worst:.3e} of each element's")
    assert worst <= 1e-3
    assert port.step == 201 and [g["lr"] for g in port.optimizer.param_groups] == [decayed]


def test_model_only_loads_the_weights_alone(trained):
    """``--ckpt x.ckpt``'s load (``model_only=True``): weights and
    statistics; a fresh optimizer, schedule and step."""
    a, path, want, _, _ = trained
    state = checkpoint.load_checkpoint(path, init_state(port_model(a.arch), LR, "cpu", seed=3),
                                       model_only=True)
    sd = state.model.state_dict()
    for key, value in FLAX_CONVERTERS[a.arch](want.params, want.batch_stats).items():
        assert torch.equal(sd[key], value), key
    assert state.step == 0 and not state.optimizer.state
    assert state.scheduler.last_epoch == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_written_ckpt_restores_in_sed_tpu_and_the_port(arch, tmp_path):
    """``tests/torch_flax_ckpt.py``'s .ckpt of a port state after 2 steps:
    ``sed_tpu.train.checkpoint.load_checkpoint`` restores the tree it was
    written from, and the port restores the state itself."""
    a = Arch(arch)
    state = init_state(port_model(arch), LR, "cpu", seed=4)
    a.port_steps(state, range(2))
    path = str(tmp_path / "iteration_2.ckpt")
    writer.write_flax_checkpoint(path, state, arch)
    tree = writer.flax_state(state, arch)
    restored = np_tree(jax_checkpoint.load_checkpoint(path, a.template()))
    assert int(restored.step) == 2
    for got, want in ((restored.params, tree["params"]),
                      (restored.batch_stats, tree["batch_stats"]),
                      (restored.opt_state[0]._asdict(), tree["opt_state"]["0"]),
                      (restored.opt_state[1]._asdict(), tree["opt_state"]["1"])):
        got, want = jax.tree.leaves(got), jax.tree.leaves(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    back = checkpoint.load_checkpoint(path, init_state(port_model(arch), LR, "cpu", seed=9))
    for key, value in state.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back.model.state_dict()[key], value), key
    for p, q in zip(state.model.parameters(), back.model.parameters()):
        assert (p in state.optimizer.state) == (q in back.optimizer.state)
        if p in state.optimizer.state:
            for k in ("step", *MOMENTS.values()):
                assert torch.equal(state.optimizer.state[p][k], back.optimizer.state[q][k])
    assert (back.step, back.scheduler.last_epoch) == (2, 2)
    assert back.optimizer.state_dict()["param_groups"] == \
        state.optimizer.state_dict()["param_groups"]


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "M5"])
def test_ckpt_resume_equals_pt_resume_in_float64(arch, tmp_path):
    """One float32 state saved as the port's .pt and written as sed_tpu's
    .ckpt: K float64 steps from either are the same."""
    a = Arch(arch)
    state = init_state(port_model(arch), LR, "cpu", seed=4)
    a.port_steps(state, range(2))
    pt = checkpoint.save_checkpoint(state, str(tmp_path), 2)
    ckpt = pt.replace(".pt", ".ckpt")
    writer.write_flax_checkpoint(ckpt, state, arch)
    runs = []
    for path in (pt, ckpt):
        resumed = checkpoint.load_checkpoint(
            path, init_state(port_model(arch).double(), LR, "cpu", seed=8))
        losses = a.port_steps(resumed, range(2, 2 + K), torch.float64)
        runs.append((losses, resumed.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        if not key.endswith("num_batches_tracked"):   # sed_tpu keeps no such count
            assert torch.equal(runs[1][1][key], value), key


def test_latest_checkpoint_counts_both_packages_files(tmp_path):
    """The largest iteration of .pt, .ckpt and .ckpt.orbax, ties to the
    newest; an orbax directory that wins is refused at load (no fallback
    to an older file).  On sed_tpu's own files, sed_tpu's answer."""
    ckpts = tmp_path / "checkpoints"
    ckpts.mkdir()

    def touch(name, age):
        path = ckpts / name
        if name.endswith(".orbax"):
            path.mkdir()
        else:
            path.write_bytes(b"")
        os.utime(path, (time.time() - age, time.time() - age))
        return str(path)

    touch("iteration_3.pt", 50)
    touch("iteration_4.ckpt.orbax", 40)
    newest_ckpt = touch("iteration_5.ckpt", 30)
    touch("iteration_x.ckpt", 0)
    touch("notes.txt", 0)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == newest_ckpt
    assert jax_checkpoint.latest_checkpoint(str(tmp_path)) == newest_ckpt
    newest_pt = touch("iteration_5.pt", 10)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == newest_pt
    orbax = touch("iteration_7.ckpt.orbax", 60)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == orbax
    assert jax_checkpoint.latest_checkpoint(str(tmp_path)) == orbax
    with pytest.raises(ValueError, match="orbax checkpoint directory.*msgpack"):
        checkpoint.load_checkpoint(orbax, init_state(CnnAvgPooling(1, SMALL), LR, "cpu"))
    assert checkpoint.latest_checkpoint(str(tmp_path / "absent")) is None


def test_a_ckpt_of_another_family_is_refused(trained, tmp_path):
    a, path, _, _, _ = trained
    other = {"CnnAvgPooling": "M5", "M5": "MobileNetV1", "MobileNetV1": "CnnAvgPooling"}
    with pytest.raises((RuntimeError, ValueError)):
        checkpoint.load_checkpoint(path, init_state(port_model(other[a.arch]), LR, "cpu"))
    with pytest.raises(ValueError, match="restores"):
        checkpoint.load_checkpoint(path, init_state(torch.nn.Linear(2, 2), LR, "cpu"))


@pytest.fixture(scope="module")
def film_clap_root(tmp_path_factory):
    """tests/test_torch_waveform_train.py's corpus: three 6 s clips at 48 kHz."""
    root = tmp_path_factory.mktemp("data")
    film_dir = root / "FilmClap" / "filmA"
    film_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    sr = DEFAULT_WAVEFORM.working_sample_rate
    labels = {}
    for i in range(3):
        sig = 0.01 * rng.standard_normal(6 * sr)
        start = 2.0 + 0.5 * i
        t = np.arange(sr) / sr
        sig[int(start * sr):int(start * sr) + sr] += 0.5 * np.sin(2 * np.pi * 2000 * t)
        path = str(film_dir / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        labels[path] = [start + 0.33, start + 0.66]
    with open(root / "FilmClap" / "paths_and_labels_fixed_Meron.txt", "w") as f:
        json.dump(labels, f)
    return str(root)


@pytest.fixture(scope="module")
def sed_tpu_run(film_clap_root, tmp_path_factory):
    """sed_tpu's training CLI (M5, the default) for 2 steps: its run
    directory holds iteration_2.ckpt."""
    root = tmp_path_factory.mktemp("sed_tpu_run")
    jax_cli_main.main(cli_argv(film_clap_root, root / "training", 2))
    (run,) = (root / "training").iterdir()
    assert sorted(os.listdir(run / "checkpoints")) == ["iteration_2.ckpt"]
    return run


def cli_argv(data, outputs_root, steps, *extra):
    return ["--dataset_dir", data, "--outputs_root", str(outputs_root), "--val_descriptor",
            "clip_2", "--batch_size", "2", "--num_train_steps", str(steps), "--log_freq", "2",
            *extra]


def metrics(run):
    with open(run / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("how", ["resume", "ckpt"])
def test_train_cli_continues_a_sed_tpu_run(how, film_clap_root, sed_tpu_run, tmp_path,
                                           capsys):
    """``cli.main --resume auto --device cpu`` in a copy of sed_tpu's run
    directory resumes from its iteration_2.ckpt and trains steps 3-4;
    ``--ckpt iteration_2.ckpt`` in a fresh one loads its weights only and
    trains steps 1-4.  sed_tpu does the same from the same file: the
    logged train and validation losses within 1e-5 (at the CLI's lr, 1e-6;
    at 1e-5 M5's first fresh Adam steps move the validation loss by 1.5e-5,
    tests/test_torch_waveform_train.py)."""
    ckpt = str(sed_tpu_run / "checkpoints" / "iteration_2.ckpt")
    extra = ["--resume", "auto"] if how == "resume" else ["--ckpt", ckpt]
    runs = {}
    for name, main, device in (("theirs", jax_cli_main.main, []),
                               ("ours", cli_main.main, ["--device", "cpu", "--no_plot"])):
        root = tmp_path / name / "training"
        if how == "resume":
            shutil.copytree(sed_tpu_run, root / sed_tpu_run.name)
        main(cli_argv(film_clap_root, root, 4, *extra, *device))
        (runs[name],) = root.iterdir()
    out = capsys.readouterr().out
    if how == "resume":
        assert f"Auto-resuming from {runs['ours'] / 'checkpoints' / 'iteration_2.ckpt'}" in out
        assert sorted(os.listdir(runs["ours"] / "checkpoints")) == \
            ["iteration_2.ckpt", "iteration_4.pt"]
        saved = torch.load(runs["ours"] / "checkpoints" / "iteration_4.pt", weights_only=True)
        assert saved["step"] == 4 and int(saved["optimizer"]["state"][0]["step"]) == 4
    else:
        assert "Auto-resuming" not in out
        assert sorted(os.listdir(runs["ours"] / "checkpoints")) == \
            ["iteration_2.pt", "iteration_4.pt"]
    ours, theirs = metrics(runs["ours"]), metrics(runs["theirs"])
    assert [r["iteration"] for r in ours] == [r["iteration"] for r in theirs] == \
        ([2, 4] if how == "resume" else [2, 4])
    first = len(metrics(sed_tpu_run)) if how == "resume" else 0
    for r, q in zip(ours[first:], theirs[first:]):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(r[key], q[key], rtol=1e-5, err_msg=key)

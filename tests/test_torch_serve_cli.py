"""``sed_tpu_torch.cli.serve build`` and ``run`` beside ``sed_tpu.cli.serve``
(CPU), and ``cli.infer --bf16`` beside sed_tpu's.

Both packages build from one sed_tpu ``.ckpt`` per arch (seeded weights and
BatchNorm statistics, not a training run) at B = 2, 4 s, and run on the same
three seeded 48 kHz WAVs (two batches; one file cropped, one padded, one
shorter than an M5 frame), with ``--mean_std_file`` for the spectrogram
archs and ``--event_threshold``.  Tolerances: float32 scores within 1e-5;
int8 (each package calibrating its own artifact on ``--calib_wav``) and
QAT int8 within 5e-3 (the band between sed_tpu's own two int8 graphs;
float32 QAT parts between summation orders, so it is held to the int8
band, not to float32's); bf16 within 0.05 (sed_tpu's band on scores).  The
trimmed frame counts, the events of the CSVs (their peaks within the
scores' tolerance) and the JSON keys must be the same.
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_ckpt_convert as ckpt_tests
from sed_tpu.cli import infer as jax_infer_cli
from sed_tpu.cli import serve as jax_serve
from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.io.audio import read_multichannel_audio as jax_read
from sed_tpu.ops.featurizer import logmel_features as jax_logmel
from sed_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sed_tpu_torch.cli import infer as infer_cli
from sed_tpu_torch.cli import serve

SR = 48000
LENGTHS = (5 * SR + 321, 3 * SR + 777, SR // 2)
ARCHS = ("CnnAvgPooling", "MobileNetV1", "M5")
ATOL, BAND, BF16_BAND = 1e-5, 5e-3, 0.05
# The featurizer tiers' score bands against the parity scores (sed_tpu's
# hardware record: 0 and 6.2e-4, benchmarks/FAST_FEATURIZER.json); on the CPU
# sed_tpu's artifact runs its XLA featurizer, which ignores the tier.
FAST_BAND, TURBO_BAND = 1e-4, 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded WAVs, a sed_tpu .ckpt per arch and normalization statistics."""
    root = tmp_path_factory.mktemp("serve")
    wavs = []
    for i, n in enumerate(LENGTHS):
        path = root / f"clip{i}.wav"
        wavfile.write(path, SR, (3000 * np.random.default_rng(i).standard_normal(n))
                      .astype(np.int16))
        wavs.append(str(path))
    ckpts = {}
    for seed, arch in enumerate(ARCHS):
        _, state = ckpt_tests.seeded_state(arch, seed=seed, step=3)
        ckpts[arch] = jax_save_checkpoint(state, str(root / arch), 3)
    cfg = JaxSpectrogramConfig()
    feats = np.asarray(jax_logmel(jnp.asarray(jax_read(wavs[1], target_fs=SR, cfg=cfg)), cfg))
    with open(root / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": feats.mean(axis=(0, 1)), "std": feats.std(axis=(0, 1))}, f)
    return root, wavs, ckpts, str(root / "mean_std.pkl")


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def build_and_run(main, name, arch, extra, files, tmp_path, capsys, device=()):
    """Build an artifact with ``main`` and run it on the three WAVs; returns
    (build JSON, run JSON, outputs dir)."""
    root, wavs, ckpts, mean_std = files
    out = tmp_path / name
    argv = ["build", "--ckpt", ckpts[arch], "--arch", arch, "--batch", "2", "--seconds", "4",
            "--out", str(tmp_path / f"{name}.aot"), *extra, *device]
    if arch != "M5":
        argv += ["--mean_std_file", mean_std]
    main(argv)
    built = last_json(capsys)
    main(["run", "--artifact", str(tmp_path / f"{name}.aot"), *wavs, "--outputs_dir", str(out),
          "--event_threshold", "0.5", *device])
    return built, last_json(capsys), out


def assert_same_events(ours, theirs, tol):
    """The same events (class, start, end) in the same order; each event's
    peak score, written with 6 decimals, within the scores' tolerance."""
    rows = [[line.split(",") for line in p.read_text().splitlines()] for p in (ours, theirs)]
    assert len(rows[0]) == len(rows[1]) and rows[0][0] == rows[1][0]
    for a, b in zip(*rows):
        assert a[:-1] == b[:-1]
        if a is not rows[0][0]:
            assert abs(float(a[-1]) - float(b[-1])) <= tol + 1e-6


CASES = {
    "CnnAvgPooling-f32": ("CnnAvgPooling", [], ATOL),
    "MobileNetV1-f32": ("MobileNetV1", [], ATOL),
    "M5-f32": ("M5", [], ATOL),
    "CnnAvgPooling-int8": ("CnnAvgPooling", ["--quantize", "int8", "--calib_wav", "WAV"], BAND),
    "MobileNetV1-int8": ("MobileNetV1", ["--quantize", "int8", "--calib_wav", "WAV"], BAND),
    "M5-int8": ("M5", ["--quantize", "int8", "--calib_wav", "WAV"], BAND),
    "CnnAvgPooling-qat": ("CnnAvgPooling", ["--quantize", "int8", "--calib_wav", "WAV",
                                            "--qat_steps", "3"], BAND),
    "CnnAvgPooling-bf16": ("CnnAvgPooling", ["--bf16"], BF16_BAND),
    "M5-bf16": ("M5", ["--bf16"], BF16_BAND),
    # sed_tpu rebuilds MobileNetV1's logits view in float32, so --bf16
    # scores in float32 there (and in the port, fault F1): float32's budget.
    "MobileNetV1-bf16": ("MobileNetV1", ["--bf16"], ATOL),
    # Once refused as not ported: the port bakes K1t into the artifact.
    "CnnAvgPooling-fast": ("CnnAvgPooling", ["--featurizer_precision", "fast"], FAST_BAND),
    "MobileNetV1-turbo": ("MobileNetV1", ["--featurizer_precision", "turbo"], TURBO_BAND),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_build_and_run_follow_sed_tpu(case, files, tmp_path, capsys):
    arch, extra, tol = CASES[case]
    _, wavs, _, _ = files
    extra = [wavs[0] if e == "WAV" else e for e in extra]
    jb, jr, jout = build_and_run(jax_serve.main, "theirs", arch, extra, files, tmp_path, capsys)
    pb, pr, pout = build_and_run(serve.main, "ours", arch, extra, files, tmp_path, capsys,
                                 device=["--device", "cpu"])
    assert set(pb) == set(jb) and set(pr) == set(jr)
    keys = ("arch", "batch", "seconds", "quantize") + (
        ("featurizer_precision",) if arch != "M5" else ())
    assert {k: pb[k] for k in keys} == {k: jb[k] for k in keys}
    assert pr["files"] == jr["files"] == len(wavs)
    worst = 0.0
    for i in range(len(wavs)):
        ours, theirs = (np.load(d / f"clip{i}_scores.npy") for d in (pout, jout))
        assert ours.shape == theirs.shape, (i, ours.shape, theirs.shape)
        if ours.size:
            worst = max(worst, float(np.abs(ours - theirs).max()))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol, err_msg=f"clip{i}")
        assert_same_events(pout / f"clip{i}_events.csv", jout / f"clip{i}_events.csv", tol)
    print(f"{case}: serve run, port vs sed_tpu max {worst:.3e} (tol {tol})")


def test_mobilenet_bf16_artifact_is_the_float32_artifact(files, tmp_path, capsys):
    """F1: ``build --bf16 --arch MobileNetV1`` exports the float32 logits
    view of the loaded weights, as sed_tpu's serve build does, and says so
    on stderr: its scores equal the float32 artifact's."""
    _, wavs, ckpts, mean_std = files
    cpu = ["--device", "cpu"]
    _, _, f32 = build_and_run(serve.main, "f32", "MobileNetV1", [], files, tmp_path, capsys,
                              device=cpu)
    serve.main(["build", "--ckpt", ckpts["MobileNetV1"], "--arch", "MobileNetV1", "--batch",
                "2", "--seconds", "4", "--out", str(tmp_path / "bf16.aot"),
                "--mean_std_file", mean_std, "--bf16", *cpu])
    assert "--bf16 serves MobileNetV1 in float32" in capsys.readouterr().err
    serve.main(["run", "--artifact", str(tmp_path / "bf16.aot"), *wavs, "--outputs_dir",
                str(tmp_path / "bf16"), *cpu])
    for i in range(len(wavs)):
        np.testing.assert_array_equal(np.load(tmp_path / "bf16" / f"clip{i}_scores.npy"),
                                      np.load(f32 / f"clip{i}_scores.npy"))


@pytest.mark.parametrize("arch", ARCHS)
def test_infer_cli_bf16_follows_sed_tpu(arch, files, tmp_path):
    """``cli.infer --bf16`` on one file (the per-file path) in both packages:
    scores within sed_tpu's bf16 band."""
    _, wavs, ckpts, _ = files
    out = {}
    for name, main in (("ours", infer_cli.main), ("theirs", jax_infer_cli.main)):
        out[name] = tmp_path / name
        argv = [wavs[1], "--ckpt", ckpts[arch], "--arch", arch, "--bf16", "--no_plot",
                "--outputs_dir", str(out[name])]
        main(argv + (["--device", "cpu"] if name == "ours" else []))
    ours, theirs = (np.load(out[k] / "clip1_scores.npy") for k in ("ours", "theirs"))
    assert ours.shape == theirs.shape and ours.shape[0] > 0
    print(f"{arch}: cli.infer --bf16, port vs sed_tpu max {np.abs(ours - theirs).max():.3e}")
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=BF16_BAND)


REFUSED = {
    "qat-without-int8": ("CnnAvgPooling", ["--qat_steps", "3"]),
    "bf16-and-int8": ("CnnAvgPooling", ["--bf16", "--quantize", "int8"]),
    "qat-mobilenet": ("MobileNetV1", ["--quantize", "int8", "--qat_steps", "3"]),
    "qat-m5": ("M5", ["--quantize", "int8", "--qat_steps", "3"]),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_build_refusals_match_sed_tpu(case, files, tmp_path):
    arch, extra = REFUSED[case]
    _, _, ckpts, _ = files
    argv = ["build", "--ckpt", ckpts[arch], "--arch", arch, "--out", str(tmp_path / "x.aot"),
            *extra]
    messages = []
    for main in (serve.main, jax_serve.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        messages.append(str(exc.value.code))
    assert messages[0] == messages[1]


def test_run_refuses_a_sed_tpu_artifact_and_a_device_it_was_not_built_for(files, tmp_path,
                                                                         capsys):
    _, wavs, ckpts, _ = files
    common = ["--ckpt", ckpts["M5"], "--arch", "M5", "--batch", "1", "--seconds", "1"]
    jax_serve.main(["build", *common, "--out", str(tmp_path / "theirs.aot")])
    with pytest.raises(ValueError, match="sed_tpu_torch.cli.serve build"):
        serve.main(["run", "--artifact", str(tmp_path / "theirs.aot"), wavs[0],
                    "--device", "cpu"])
    serve.main(["build", *common, "--out", str(tmp_path / "ours.aot"), "--device", "cpu"])
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["run", "--artifact", str(tmp_path / "ours.aot"), wavs[0]])
    with pytest.raises(ValueError, match="traced on cpu"):
        serve.main(["run", "--artifact", str(tmp_path / "ours.aot"), wavs[0],
                    "--device", "meta"])

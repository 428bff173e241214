"""Sharded serving artifacts (``sed_tpu_torch.export`` ``mesh=``,
``cli/serve.py build --num_devices``) at gloo world size 2 on the CPU,
against ``sed_tpu``'s sharded artifacts on ``create_mesh(2)`` of its
8-virtual-device CPU platform and against the port's 1-device artifacts.

One group of two CPU ranks is spawned for the library's artifacts
(``multihost.launch``, ``tests/torch_sharded_worker.py``): each rank loads
every artifact with its mesh, scores the global batch and saves what it
got.  Sizes are tests/test_torch_export.py's (8 kHz, 4 s, CnnAvgPooling
((8, 2), (16, 2))) at B = 4, two rows a rank.  Tolerances: scores within
1e-5 of ``sed_tpu``'s sharded artifact (the port's budget; the int8
artifact carries ``sed_tpu``'s qparams across, and measured equal); a
sharded artifact against the port's 1-device artifact within 1e-6
(sharded against unsharded scores, tests/test_parallel.py:95: the CPU's
float32 convolutions round differently at 2 and 4 rows, 6e-8-1.2e-7
measured), and each rank's scores equal to the other's.
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
from scipy.io import wavfile

import test_torch_ckpt_convert as ckpt_tests
import test_torch_export as export_tests
import torch_sharded_worker as worker
from sed_tpu import export as jex
from sed_tpu.cli import serve as jax_serve
from sed_tpu.models import quantize as jq
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnn
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.ops.featurizer import logmel_features_batch as jax_logmel_batch
from sed_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sed_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sed_tpu_torch import export as ex
from sed_tpu_torch.cli import serve
from sed_tpu_torch.models.cnn import CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          mobilenet_state_dict, qparams_from_flax)
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.parallel import multihost
from sed_tpu_torch.parallel.mesh import create_mesh

CFG, JCFG, WCFG, JWCFG = (export_tests.CFG, export_tests.JCFG, export_tests.WCFG,
                          export_tests.JWCFG)
NARROW = export_tests.NARROW
B, SAMPLES = 4, export_tests.SAMPLES
M5_SAMPLES = 4 * WCFG.frame_size + 123
FEATURE_FRAMES = 32
ATOL, SHARD_TOL = 1e-5, 1e-6
SR, CLI_BATCH = 48000, 2
# cli/serve.py build's tiers of the spectrogram families ("WAV": --calib_wav).
TIERS = {"f32": [], "bf16": ["--bf16"], "int8": ["--quantize", "int8", "--calib_wav", "WAV"],
         "qat": ["--quantize", "int8", "--calib_wav", "WAV", "--qat_steps", "3"]}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pcm(seed, samples=SAMPLES, scale=4000):
    return (np.random.default_rng(seed).standard_normal((B, samples, 1)) * scale) \
        .astype(np.int16)


def families():
    """{arch: (flax module, port module, params, batch stats)}, seeded as
    tests/test_torch_export.py seeds them."""
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
        params, stats = export_tests.seeded(flax_model, sample, seed)
        port.load_state_dict(convert(params, stats), strict=True)
        out[name] = (flax_model, port.eval(), params, stats)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A sed_tpu .ckpt of CnnAvgPooling (full width, seeded), 48 kHz WAVs
    (one cropped, one padded, one in a second batch) and normalization
    statistics, for both packages' serve CLIs."""
    root = tmp_path_factory.mktemp("serve_files")
    wavs = []
    for i, n in enumerate((5 * SR + 321, 3 * SR + 777, 4 * SR)):
        path = root / f"clip{i}.wav"
        wavfile.write(path, SR, (3000 * np.random.default_rng(i).standard_normal(n))
                      .astype(np.int16))
        wavs.append(str(path))
    _, state = ckpt_tests.seeded_state("CnnAvgPooling", step=3)
    # M5 is refused before its checkpoint is read.
    ckpts = dict.fromkeys(("CnnAvgPooling", "M5"),
                          jax_save_checkpoint(state, str(root / "cnn"), 3))
    rng = np.random.default_rng(7)
    with open(root / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": rng.uniform(-60, -40, 64).astype(np.float32),
                     "std": rng.uniform(5, 15, 64).astype(np.float32)}, f)
    return root, wavs, ckpts, str(root / "mean_std.pkl")


def cli_argv(tier, files, out, num_devices=1):
    """(build argv, run argv) of one serving tier at --batch 2, 4 s."""
    root, wavs, ckpts, mean_std = files
    build = ["build", "--ckpt", ckpts["CnnAvgPooling"], "--batch", str(CLI_BATCH),
             "--seconds", "4", "--out", str(out / f"{tier}.aot"), "--mean_std_file",
             mean_std, "--device", "cpu", "--num_devices", str(num_devices),
             *[wavs[0] if f == "WAV" else f for f in TIERS[tier]]]
    run = ["run", "--artifact", str(out / f"{tier}.aot"), *wavs, "--outputs_dir",
           str(out / tier), "--event_threshold", "0.5", "--device", "cpu"]
    return build, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory, files):
    """(artifacts {tag: (sharded, 1-device)}, audio {tag: batch}, sed_tpu's
    sharded scores {tag} and its sharded cnn_f32 artifact, the two ranks'
    results, the ranks' CLI outputs dir)."""
    root = tmp_path_factory.mktemp("sharded")
    fams = families()
    jmesh = jax_create_mesh(2)
    audio = {"cnn_f32": pcm(1), "cnn_int8": pcm(2), "mobilenet_f32": pcm(3),
             "m5_f32": pcm(4, M5_SAMPLES, 3000),
             "scorer": np.random.default_rng(5).standard_normal(
                 (B, 1, FEATURE_FRAMES, CFG.mel_bins)).astype(np.float32)}
    feats = np.asarray(jax_logmel_batch(jnp.asarray(pcm(9)), JCFG))
    norm = feats.mean(axis=(0, 1, 2)), feats.std(axis=(0, 1, 2))
    blobs = {}

    def jax_pipeline(head, tag):
        blobs[tag] = jex.aot_export_pipeline(*head, B, SAMPLES, JCFG, use_pallas=False,
                                             mesh=jmesh)
        return jex.load_aot_pipeline(blobs[tag])(audio[tag])

    cnn, port_cnn, params, stats = fams["CnnAvgPooling"]
    theirs = {"cnn_f32": jax_pipeline(jex.cnn_serving(cnn, params, stats, *norm), "cnn_f32")}
    calib = (np.asarray(jax_logmel_batch(jnp.asarray(audio["cnn_int8"]), JCFG)) - norm[0]) \
        / norm[1]
    q = jq.quantize_cnn(cnn, params, stats, [np.transpose(calib, (0, 2, 3, 1))])
    theirs["cnn_int8"] = jax_pipeline(jex.quantized_serving(q, *norm), "cnn_int8")
    mob, port_mob, mparams, mstats = fams["MobileNetV1"]
    theirs["mobilenet_f32"] = jax_pipeline(
        jex.cnn_serving(mob, mparams, mstats, *norm), "mobilenet_f32")
    m5, port_m5, wparams, wstats = fams["M5"]
    theirs["m5_f32"] = jex.load_aot_pipeline(jex.aot_export_m5_pipeline(
        *jex.m5_serving(m5, wparams, wstats), B, M5_SAMPLES, JWCFG, mesh=jmesh))(
        audio["m5_f32"])

    heads = {"cnn_f32": ("pipeline", ex.cnn_serving(port_cnn, *norm), CFG),
             "cnn_int8": ("pipeline", ex.quantized_serving(
                 qparams_from_flax(jax.tree.map(np.asarray, q)), *norm), CFG),
             "mobilenet_f32": ("pipeline", ex.cnn_serving(port_mob, *norm), CFG),
             "m5_f32": ("m5", ex.m5_serving(port_m5), WCFG),
             "scorer": ("fn", ex.cnn_serving(port_cnn, *norm), CFG)}
    cli_out = root / "cli"
    cli_out.mkdir()
    cli = [cli_argv(tier, files, cli_out, num_devices=2) for tier in TIERS]
    torch.save({"heads": heads, "audio": audio, "cli": cli}, root / "inputs.pt")
    multihost.launch(worker.rank_main, 2, "cpu", args=(str(root),))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    artifacts = {tag: ((root / f"{tag}.aot").read_bytes(),
                       worker.export(kind, head, audio[tag], cfg, None))
                 for tag, (kind, head, cfg) in heads.items()}
    return artifacts, audio, theirs, blobs["cnn_f32"], ranks, cli_out


def header(blob):
    return json.loads(zipfile.ZipFile(io.BytesIO(blob)).read("header.json"))


@pytest.mark.parametrize("tag", ["cnn_f32", "cnn_int8", "mobilenet_f32", "m5_f32"])
def test_sharded_artifact_on_two_ranks_matches_sed_tpu_and_one_device(runs, tag):
    """Each rank scores the global batch with the sharded artifact: both
    ranks get the same scores, within 1e-6 of the port's 1-device artifact
    and within 1e-5 of sed_tpu's sharded artifact; the header
    keeps the global input shape and adds 2 devices and the shard shape."""
    artifacts, audio, theirs, _, ranks, _ = runs
    got = ranks[0][tag]
    np.testing.assert_array_equal(got["scores"], ranks[1][tag]["scores"])
    np.testing.assert_array_equal(got["raw"], got["scores"])
    one = ex.load_aot_pipeline(artifacts[tag][1], device="cpu")(audio[tag])
    shard_err = float(np.abs(got["scores"] - one).max())
    theirs_err = float(np.abs(got["scores"] - theirs[tag]).max())
    print(f"{tag}: sharded vs 1-device {shard_err:.3e} (equal: "
          f"{np.array_equal(got['scores'], one)}), vs sed_tpu's sharded {theirs_err:.3e}")
    assert got["scores"].shape == one.shape == theirs[tag].shape
    assert shard_err <= SHARD_TOL
    assert theirs_err <= ATOL
    shape = list(audio[tag].shape)
    assert got["input_shape"] == tuple(shape) and got["n_devices"] == 2
    assert got["shard_shape"] == (B // 2, *shape[1:]) and got["device"] == "cpu"
    sharded, single = header(artifacts[tag][0]), header(artifacts[tag][1])
    assert (sharded["n_devices"], sharded["shard_shape"]) == (2, [B // 2, *shape[1:]])
    assert (single["n_devices"], single["shard_shape"]) == (1, shape)
    assert sharded["input_shape"] == single["input_shape"] == shape


def test_sharded_head_through_load_scorer(runs):
    """``aot_export_fn(mesh=)`` of a head on features, loaded with
    ``load_scorer(mesh=)`` on each rank: the 1-device scorer's scores."""
    artifacts, audio, _, _, ranks, _ = runs
    want = ex.load_scorer(artifacts["scorer"][1])(audio["scorer"])
    for rank in ranks:
        np.testing.assert_allclose(rank["scorer"]["scores"], want, rtol=0, atol=SHARD_TOL)


def test_a_sharded_artifact_needs_a_mesh_of_its_size(runs):
    artifacts, audio, _, _, _, _ = runs
    with pytest.raises(ValueError, match="compiled for 2 devices: each rank of a 2-rank "
                                         "mesh.*got no mesh"):
        ex.load_aot_pipeline(artifacts["cnn_f32"][0], device="cpu")
    # An artifact without the fields (the format's first headers) is a
    # 1-device one, as sed_tpu reads it (d.get("n_devices", 1)).
    old = {k: v for k, v in header(artifacts["cnn_f32"][1]).items()
           if k not in ("n_devices", "shard_shape")}
    call = ex.load_aot_pipeline(_replace_header(artifacts["cnn_f32"][1], old))
    assert call.n_devices == 1 and call.shard_shape == call.input_shape
    np.testing.assert_array_equal(
        call(audio["cnn_f32"]), ex.load_aot_pipeline(artifacts["cnn_f32"][1])(audio["cnn_f32"]))


def _replace_header(blob, new):
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        for name in src.namelist():
            z.writestr(name, json.dumps(new) if name == "header.json" else src.read(name))
    return out.getvalue()


def program_devices(program) -> set:
    """Every device ``program`` names: its weights and constants, the
    device arguments of its nodes and their tensor metadata."""
    found = {t.device for t in (*program.state_dict.values(), *program.constants.values())
             if isinstance(t, torch.Tensor)}
    for node in program.graph.nodes:
        if "device" in node.kwargs:
            found.add(torch.device(node.kwargs["device"]))
        if node.op == "call_function" and node.target is torch.ops.aten.to.device:
            found.add(torch.device(node.args[1]))
        vals = node.meta.get("val")
        for v in vals if isinstance(vals, (list, tuple)) else [vals]:
            if isinstance(v, torch.Tensor):
                found.add(v.device)
    return found


def test_placement_names_only_the_device_asked_for(runs):
    """The trap of a rank's device: a program traced on one device names it
    in its weights, its constants (the featurizer's tables) and its graph
    (the input's ``_assert_tensor_metadata``).  ``place_program`` moves all
    of them; the meta device stands in for another card here."""
    artifacts = runs[0]
    for tag in ("cnn_f32", "cnn_int8", "m5_f32"):
        program = torch.export.load(io.BytesIO(
            zipfile.ZipFile(io.BytesIO(artifacts[tag][0])).read("program.pt2")))
        assert program_devices(program) == {torch.device("cpu")}
        assert any("device" in n.kwargs for n in program.graph.nodes)
        placed = ex.place_program(program, torch.device("meta"))
        assert program_devices(placed) == {torch.device("meta")}, tag


def test_each_rank_places_the_program_on_its_own_device(runs, monkeypatch):
    """The loader places the program on the mesh's device (world size 1
    here, the sharded artifacts' ranks in the worker); a 1-device artifact
    on a one-rank mesh runs its rows and the gather: the same scores."""
    artifacts, audio, _, _, _, _ = runs
    placed = []
    place = ex.place_program
    monkeypatch.setattr(ex, "place_program", lambda p, d: placed.append(d) or place(p, d))
    mesh = create_mesh(1, devices=["cpu"])
    try:
        call = ex.load_aot_pipeline(artifacts["cnn_f32"][1], mesh=mesh)
        got = call(audio["cnn_f32"])
    finally:
        multihost.shutdown_multihost()
    assert placed == [mesh.device] and call.device == mesh.device
    np.testing.assert_array_equal(
        got, ex.load_aot_pipeline(artifacts["cnn_f32"][1])(audio["cnn_f32"]))


def test_too_few_cards_get_sed_tpus_message(runs, monkeypatch):
    """A 2-device CUDA artifact on a host with one card: sed_tpu's words
    (its 2-device artifact on a host whose jax.devices() is one)."""
    artifacts, _, _, jax_blob, _, _ = runs
    cuda = _replace_header(artifacts["cnn_f32"][0],
                           {**header(artifacts["cnn_f32"][0]), "device_type": "cuda"})
    monkeypatch.setattr(ex, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    messages = []
    for load in (ex.load_aot_pipeline, lambda b: ex.artifact_devices(b, "cuda")):
        with pytest.raises(ValueError) as exc:
            load(cuda)
        messages.append(str(exc.value))
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    with pytest.raises(ValueError) as exc:
        jex.load_aot_pipeline(jax_blob)
    assert messages == [str(exc.value)] * 2
    assert messages[0] == "artifact was compiled for 2 devices; this host has 1"


@pytest.mark.parametrize("tier", list(TIERS))
def test_serve_cli_on_two_ranks_writes_the_one_device_outputs(runs, files, tier, tmp_path,
                                                              capsys):
    """``cli/serve.py``'s ``build`` and ``run`` on each rank of the
    two-rank group (the worker) against both on one device: rank 0's
    ``.npy`` files within 1e-6 (the CPU's float32 convolutions round
    differently at 1 and 2 rows: 2.4e-7 measured; the bf16, int8 and QAT
    tiers measured equal) and the same event CSVs."""
    cli_out = runs[5]
    build, run = cli_argv(tier, files, tmp_path)
    serve.main(build)
    serve.main(run)
    assert header((cli_out / f"{tier}.aot").read_bytes())["n_devices"] == 2
    for i in range(3):
        got = np.load(cli_out / tier / f"clip{i}_scores.npy")
        want = np.load(tmp_path / tier / f"clip{i}_scores.npy")
        print(f"{tier} clip{i}: 2 ranks vs 1 device {np.abs(got - want).max():.3e}")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=SHARD_TOL)
        ours, theirs = ((d / tier / f"clip{i}_events.csv").read_text().splitlines()
                        for d in (cli_out, tmp_path))
        assert [r.split(",")[:-1] for r in ours] == [r.split(",")[:-1] for r in theirs]


def test_serve_cli_build_num_devices_then_run(runs, files, tmp_path, capfd):
    """``python -m sed_tpu_torch.cli.serve build --num_devices 2 --device
    cpu`` (two spawned ranks), then ``run --device cpu``, which reads the
    artifact's 2 devices and runs two ranks: one JSON line each, and the
    worker's outputs within 1e-6 (the spawned ranks run torch's default
    CPU threads, the worker's one)."""
    cli_out = runs[5]
    build, run = cli_argv("f32", files, tmp_path, num_devices=2)
    serve.main(build)
    built = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert built["num_devices"] == 2 and built["batch"] == CLI_BATCH
    assert header((tmp_path / "f32.aot").read_bytes())["n_devices"] == 2
    serve.main(run)
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["files"] == 3
    for i in range(3):
        np.testing.assert_allclose(np.load(tmp_path / "f32" / f"clip{i}_scores.npy"),
                                   np.load(cli_out / "f32" / f"clip{i}_scores.npy"),
                                   rtol=0, atol=SHARD_TOL)


REFUSED = {
    "m5": ("M5", ["--num_devices", "2"]),
    "batch": ("CnnAvgPooling", ["--num_devices", "3", "--batch", "16"]),
    "devices": ("CnnAvgPooling", ["--num_devices", "16", "--batch", "16"]),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_build_num_devices_refusals_are_sed_tpus(case, files, tmp_path, monkeypatch):
    """sed_tpu's three refusals of ``build --num_devices``, word for word:
    M5, a batch that does not divide, more devices than visible (sed_tpu's
    CPU platform has 8; the port's CUDA host is given 8 cards)."""
    arch, extra = REFUSED[case]
    _, _, ckpts, mean_std = files
    argv = ["build", "--ckpt", ckpts[arch], "--arch", arch, "--seconds", "4",
            "--out", str(tmp_path / "x.aot"), *extra]
    with pytest.raises(SystemExit) as theirs:
        jax_serve.main(argv)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    with pytest.raises(SystemExit) as ours:
        serve.main(argv)
    assert str(ours.value.code) == str(theirs.value.code)
    assert not (tmp_path / "x.aot").exists()

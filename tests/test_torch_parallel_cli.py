"""``--num_devices`` in the port's CLIs at ``--device cpu``: two gloo ranks
spawned by ``parallel.multihost.launch``, held against the same CLI on one
rank, and the refusals, with ``sed_tpu``'s messages.

Tolerances: ``cli.main``'s losses within rtol 1e-5 and its checkpoint's
weights and BatchNorm statistics within 1e-5 after 4 steps (at the CLI's lr
1e-6); scores of ``cli.infer --batch`` and ``cli.stream`` within 1e-6 of the
one-rank run (``cli.stream`` with ``--featurizer xla`` and with its
default 'auto', K3 + K2 on each rank).
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import torch_parallel_worker as worker
from sed_tpu.cli import infer as jax_infer_cli
from sed_tpu_torch.cli import infer as infer_cli
from sed_tpu_torch.cli import main as cli_main
from sed_tpu_torch.cli import stream as stream_cli
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.parallel import multihost
from test_torch_train_loop import film_clap_root  # noqa: F401  (a fixture)

SR = 48000
SHARD_TOL, STEP_RTOL, STEP_ATOL = 1e-6, 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scoring(tmp_path_factory):
    """A seeded CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) checkpoint and three
    48 kHz WAVs, two of one length (an odd count: groups of 2 and 1)."""
    root = tmp_path_factory.mktemp("parallel_cli")
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(2))
    ckpt = root / "model.pth"
    torch.save({"model": model.state_dict()}, ckpt)
    wavs = []
    for i, n in enumerate((4 * SR + 777, 4 * SR + 777, 3 * SR + 5)):
        path = root / f"clip{i}.wav"
        wavfile.write(path, SR, (3000 * np.random.default_rng(i).standard_normal(n))
                      .astype(np.int16))
        wavs.append(str(path))
    return str(ckpt), wavs


def scores_of(out_dir, wavs):
    return [np.load(os.path.join(out_dir, f"clip{i}_scores.npy")) for i in range(len(wavs))]


def test_train_cli_on_two_ranks_matches_one_rank(film_clap_root, tmp_path):  # noqa: F811
    """``cli.main --num_devices 2`` writes the files of a one-rank run, with
    its losses, metrics and weights."""
    runs = {}
    for n in (1, 2):
        root = str(tmp_path / f"ranks{n}")
        cli_main.main(["--dataset_dir", film_clap_root, "--dataset_name", "FilmClap",
                       "--train_features", "Spectogram", "--outputs_root", root,
                       "--val_descriptor", "clip_3", "--batch_size", "4", "--log_freq", "2",
                       "--num_train_steps", "4", "--device", "cpu", "--no_plot",
                       "--num_devices", str(n)])
        (run,) = os.listdir(root)
        runs[n] = os.path.join(root, run)
    assert os.path.basename(runs[1]) == os.path.basename(runs[2])
    for sub in ("", "checkpoints"):
        assert sorted(os.listdir(os.path.join(runs[2], sub))) == \
            sorted(os.listdir(os.path.join(runs[1], sub)))
    records = {}
    for n, run in runs.items():
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records[n] = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records[2]] == [r["iteration"] for r in records[1]] == [2, 4]
    for a, b in zip(records[2], records[1]):
        assert set(a) == set(b)
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[key], b[key], rtol=STEP_RTOL, err_msg=key)
    ckpts = {n: torch.load(os.path.join(run, "checkpoints", "iteration_4.pt"),
                           weights_only=True) for n, run in runs.items()}
    assert ckpts[2]["step"] == ckpts[1]["step"] == 4
    for key, value in ckpts[1]["model"].items():
        torch.testing.assert_close(ckpts[2]["model"][key], value, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, msg=key)


def test_infer_cli_batch_on_two_ranks_matches_one_rank(scoring, tmp_path):
    ckpt, wavs = scoring
    outs = {}
    for n in (1, 2):
        outs[n] = str(tmp_path / f"ranks{n}")
        infer_cli.main([*wavs, "--ckpt", ckpt, "--batch", "--device", "cpu", "--no_plot",
                        "--outputs_dir", outs[n], "--num_devices", str(n),
                        "--event_threshold", "0.5"])
    assert sorted(os.listdir(outs[2])) == sorted(os.listdir(outs[1]))
    for a, b in zip(scores_of(outs[2], wavs), scores_of(outs[1], wavs)):
        assert a.shape == b.shape and a.shape[0] > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=SHARD_TOL)


def test_stream_cli_on_two_ranks_matches_the_xla_tick_on_one(scoring, tmp_path):
    """Three files on ``--slots 3``, rounded up to 4 over two ranks, against
    one rank's 4-slot pool, with ``--featurizer xla`` and with 'auto'."""
    ckpt, wavs = scoring
    for feat in ("xla", "auto"):
        outs = {}
        for n, extra in ((1, ["--slots", "4"]), (2, ["--slots", "3", "--num_devices", "2"])):
            outs[n] = str(tmp_path / f"{feat}{n}")
            stream_cli.main([*wavs, "--ckpt", ckpt, "--device", "cpu", "--outputs_dir",
                             outs[n], "--stagger_ticks", "1", "--featurizer", feat, *extra])
        assert sorted(os.listdir(outs[2])) == sorted(os.listdir(outs[1]))
        for a, b in zip(scores_of(outs[2], wavs), scores_of(outs[1], wavs)):
            assert a.shape == b.shape and a.shape[0] > 0
            np.testing.assert_allclose(a, b, rtol=0, atol=SHARD_TOL, err_msg=feat)


def test_num_devices_without_batch_is_refused_as_sed_tpu_does(capsys):
    errs = []
    for main in (infer_cli.main, jax_infer_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["a.wav", "--ckpt", "unused.pth", "--num_devices", "2"])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1]
    assert "--num_devices shards the batched path; add --batch" in errs[0]


@pytest.mark.parametrize("cli", ["main", "infer", "stream"])
def test_more_ranks_than_visible_cards_is_refused_before_any_work(cli, tmp_path):
    """With ``--device cuda`` the ranks may not outnumber the visible cards:
    ``sed_tpu``'s message, before any file is read."""
    n = max(2, torch.cuda.device_count() + 1)
    argv = {
        "main": (cli_main.main, ["--dataset_dir", str(tmp_path / "absent"), "--no_plot"]),
        "infer": (infer_cli.main, ["absent.wav", "--ckpt", "absent.pth", "--batch",
                                   "--no_plot"]),
        "stream": (stream_cli.main, ["absent.wav", "--ckpt", "absent.pth"]),
    }[cli]
    with pytest.raises(SystemExit) as exc:
        argv[0]([*argv[1], "--device", "cuda", "--num_devices", str(n)])
    assert str(exc.value.code) == (f"--num_devices {n} but only "
                                   f"{torch.cuda.device_count()} devices are visible")


def test_indivisible_batch_and_launch_faults(tmp_path, monkeypatch):
    """``--batch_size`` must divide over the ranks (``sed_tpu``'s message,
    before any work); a rank that raises fails the launch, the rank waiting
    for it stopped; under torchrun the world size must match."""
    with pytest.raises(ValueError, match="global batch_size=5 must be divisible by the "
                                         "mesh size 2"):
        cli_main.main(["--dataset_dir", str(tmp_path / "absent"), "--device", "cpu",
                       "--no_plot", "--batch_size", "5", "--num_devices", "2"])
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        multihost.launch(worker.fail_on_rank_1, 2, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="--num_devices 2 but torchrun started 3"):
        multihost.launch(worker.fail_on_rank_1, 2, "cpu")

"""The port's data-parallel cases, run once on one device and once on each
rank of a gloo group (tests/test_torch_parallel.py).

``run_cases(inputs, mesh)`` computes every case from the same seeded inputs:
with ``mesh=None`` the single-device path, with a mesh this rank's part of
the sharded one.  ``rank_main`` is what each spawned rank runs: it joins the
two-rank CPU mesh, runs the cases and saves its results beside the inputs.
This module imports torch and the port only, so the ranks start without JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.device_streaming import DeviceStreamingDetector
from sed_tpu_torch.inference import (batch_predict_files, make_batch_evaluator,
                                     make_batch_predictor)
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.parallel.data_parallel import shard_inference, shard_train_step
from sed_tpu_torch.stream_pool import StreamPool
from sed_tpu_torch.train.state import init_state, make_eval_forward
from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool

TRAIN_CFG = SpectrogramConfig()                       # tests/test_parallel.py's
SCFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
SMALL = ((8, 2), (16, 2))
CHUNK = 8000
POOL_KW = dict(chunk_samples=CHUNK, halo=64, total_stride=8, bucket=64)
LATE = {3: 2}                                          # stream -> tick it joins


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _state(model, sd, device):
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return init_state(model, 1e-3, device)


def spectrogram_buffers(inp, device, dtype=torch.float32):
    crop = TRAIN_CFG.train_crop_size
    total = inp["features"].shape[1]
    return pipe.SpectrogramBuffers(
        features=torch.from_numpy(inp["features"]).to(device, dtype),
        events=torch.from_numpy(inp["events"]).to(device),
        start_indices=torch.arange(total - crop, device=device),
        mean=torch.zeros(TRAIN_CFG.mel_bins, device=device, dtype=dtype),
        std=torch.ones(TRAIN_CFG.mel_bins, device=device, dtype=dtype))


def drive_pool(pool, streams, seed):
    """Every stream joins (stream 3 at tick 2), is fed in pieces of 0.4 to
    1.6 chunks a tick and leaves through ``leave_many`` when its audio
    ends; returns each stream's scores."""
    rng = np.random.default_rng(seed)
    recs = [{"wav": w, "pos": 0, "blocks": []} for w in streams]
    waiting, active, tick = list(range(len(streams))), {}, 0
    while waiting or active:
        for i in [i for i in waiting if LATE.get(i, 0) <= tick]:
            active[pool.join()] = recs[i]
            waiting.remove(i)
        leaving = []
        for slot, rec in active.items():
            n = int(CHUNK * rng.uniform(0.4, 1.6))
            piece = rec["wav"][rec["pos"]: rec["pos"] + n]
            pool.feed(slot, piece)
            rec["pos"] += len(piece)
            if rec["pos"] >= len(rec["wav"]):
                leaving.append(slot)
        for slot, sc in pool.tick().items():
            active[slot]["blocks"].append(sc)
        tails = pool.leave_many(leaving) if leaving else {}
        for slot in leaving:
            active.pop(slot)["blocks"].append(tails[slot])
        tick += 1
    return [np.concatenate(r["blocks"]) for r in recs]


def run_cases(inputs, mesh=None) -> dict:
    device = torch.device("cpu") if mesh is None else mesh.device
    out = {}

    # CnnAvgPooling (logMel): one step at batch 16, lr 1e-3.
    inp = inputs["cnn"]
    bufs = spectrogram_buffers(inp, device)
    state = _state(CnnAvgPooling(1, SMALL), inp["state_dict"], device)
    raw = pipe.make_spectrogram_train_step(TRAIN_CFG, 5.0, "logMel", False)
    step = raw if mesh is None else shard_train_step(raw, mesh)
    out["cnn_loss"] = float(step(state, bufs, inp["starts"]))
    out["cnn_state"] = _np(state.model.state_dict())

    # The same with augmentation, two steps a call, twice (steps_per_call=2),
    # in float64: over several steps Adam turns float32 rounding in
    # near-zero gradients into lr-sized moves, on either path alike.
    bufs = spectrogram_buffers(inp, device, torch.float64)
    state = _state(CnnAvgPooling(1, SMALL).double(), inp["state_dict"], device)
    multi = pipe.make_multi_step(pipe.make_spectrogram_train_step(TRAIN_CFG, 5.0, "logMel",
                                                                  True), 2)
    step = multi if mesh is None else shard_train_step(multi, mesh, steps_per_call=2)
    gen = torch.Generator(device=device).manual_seed(5)
    out["multi_losses"] = np.concatenate(
        [step(state, bufs, block, gen).cpu().numpy() for block in inp["blocks"]])
    out["multi_state"] = _np(state.model.state_dict())

    # M5: one step at batch 8; the gradients the update applied stay on the
    # parameters (averaged over the ranks under a mesh).
    inp = inputs["m5"]
    frame = WCFG.frame_size
    wbufs = pipe.WaveformBuffers(
        waveform=torch.from_numpy(inp["waveform"]).to(device),
        labels=torch.from_numpy(inp["labels"]).to(device),
        start_indices=torch.arange(inp["waveform"].shape[1] - frame, device=device))
    state = _state(M5(1), inp["state_dict"], device)
    raw = pipe.make_waveform_train_step(WCFG, 5.0, False)
    step = raw if mesh is None else shard_train_step(raw, mesh)
    out["m5_loss"] = float(step(state, wbufs, inp["starts"]))
    out["m5_grads"] = {k: p.grad.cpu().numpy().copy()
                       for k, p in state.model.named_parameters()}
    out["m5_state"] = _np(state.model.state_dict())

    # Batch scoring: the predictor on 4 clips, shard_inference on a forward,
    # batch_predict_files on 3 files (groups of 2 and 1, padded to 2).
    inp = inputs["predict"]
    small = CnnAvgPooling(1, SMALL)
    small.load_state_dict({k: torch.as_tensor(v) for k, v in inp["state_dict"].items()})
    predict = make_batch_predictor(small, SCFG, inp["mean"], inp["std"], device=device,
                                   mesh=mesh)
    out["predict"] = predict(inp["pcm"]).cpu().numpy()
    forward = make_eval_forward(small.to(device))
    x = torch.from_numpy(inp["features"]).to(device)
    out["shard_inference"] = (forward(x) if mesh is None
                              else shard_inference(forward, mesh)(x)).cpu().numpy()
    files = batch_predict_files(small, inp["files"], SCFG, inp["mean"], inp["std"],
                                device=device, mesh=mesh)
    out["files"] = [files[p] for p in inp["files"]]
    evaluate = make_batch_evaluator(small, SCFG, inp["mean"], inp["std"], device=device,
                                    mesh=mesh)
    out["evaluate"] = [r.cpu().numpy() for r in evaluate(inp["pcm"], inp["targets"])]

    # The stream pools and the lockstep detector, slots sharded.
    inp = inputs["pool"]
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in inp["state_dict"].items()})
    # 'auto': K3 + K2 (their plain versions here) on each rank's slots.
    pool = StreamPool(model, SCFG, slots=4, featurizer="auto", mesh=mesh, device=device,
                      **POOL_KW)
    out["pool"] = drive_pool(pool, inp["streams"], seed=3)
    pool = StreamPool(model, SCFG, slots=4, featurizer="xla", mesh=mesh, device=device,
                      **POOL_KW)
    out["pool_xla"] = drive_pool(pool, inp["streams"], seed=3)
    det = DeviceStreamingDetector(model, SCFG, batch=2, mesh=mesh, device=device,
                                  **POOL_KW)
    blocks = [det.push(c) for c in inp["lockstep"]] + [det.flush()]
    out["lockstep"] = np.concatenate(blocks, axis=1)
    m5 = M5(1)
    m5.load_state_dict({k: torch.as_tensor(v) for k, v in inputs["m5"]["seeded"].items()})
    wpool = DeviceWaveformStreamPool(m5, WCFG, slots=2, chunk_samples=CHUNK, mesh=mesh,
                                     device=device)
    a, b = wpool.join(), wpool.join()
    wav_a, wav_b = inputs["m5"]["streams"]
    wpool.feed(a, wav_a)             # a backlog of several rounds
    wpool.feed(b, wav_b[:CHUNK + 123])
    got = {a: [], b: []}
    for s, sc in wpool.tick().items():
        got[s].append(sc)
    wpool.feed(b, wav_b[CHUNK + 123:])
    for s, sc in wpool.tick().items():
        got[s].append(sc)
    for s, tail in wpool.leave_many([a, b]).items():
        got[s].append(tail)
    out["wpool"] = [np.concatenate(got[a]), np.concatenate(got[b])]
    return out


def rank_main(root: str) -> None:
    """One rank: the two-rank CPU mesh, the cases and this rank's NCCL
    flight-recorder setting, ``rank{r}.pt``."""
    from sed_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    mesh = create_mesh(2, devices=["cpu", "cpu"])
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = run_cases(inputs, mesh)
    out["fr_buffer_size"] = os.environ.get("TORCH_FR_BUFFER_SIZE")
    torch.save(out, os.path.join(root, f"rank{mesh.rank}.pt"))


def fail_on_rank_1() -> None:
    """Rank 1 raises while rank 0 works on (ten minutes, unless stopped)."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 failed on purpose")
    time.sleep(600)

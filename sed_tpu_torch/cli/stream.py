"""Streaming CLI: score WAV files through a pool's lifecycle (counterpart
of ``sed_tpu.cli.stream``).

Each file becomes one stream: files join as slots free up (optionally
staggered), feed() one chunk's worth of audio per tick (the last piece is
partial, with no padding), tick() scores every stream with a full chunk in
one batched device call, and the streams whose audio ended leave together
through one leave_many(), which drains their remainders exactly.  Scores per
file equal offline scoring of the same audio.

    python -m sed_tpu_torch.cli.stream a.wav b.wav c.wav --ckpt model.pth \\
        [--arch CnnAvgPooling|MobileNetV1|M5] [--m5_pool device|host] \\
        [--chunk_seconds 1.0] [--slots 8] [--stagger_ticks 2] \\
        [--featurizer auto|pallas|xla] [--event_threshold 0.5] [--device cuda|cpu]

``--ckpt`` is read by ``cli.infer.load_model_and_state``: a port
``iteration_{n}.pt``, a reference ``.pth`` or a ``sed_tpu`` msgpack
``.ckpt``.  The spectrogram archs stream over ``StreamPool`` (device rings,
K3 + K2 a tick; ``--featurizer xla`` featurizes in PyTorch ops instead);
MobileNetV1 streams its logits view with its halo raised to its
receptive-field floor (88).  M5 streams hop-strided waveform frames over
``DeviceWaveformStreamPool`` (``--m5_pool device``, the default) or
``WaveformStreamPool`` (``host``).  Writes ``<name>_scores.npy`` (and, with
``--event_threshold``, ``<name>_events.csv``) per file and prints one JSON
summary line, which includes the kernel launch counts of the run.

``--quantize int8`` serves every arch through the int8 forward
(``models/quantize.py``), its activation scales calibrated on the first
file: M5 on its hop-strided frames, the spectrogram archs on its log-mel
features (normalized by ``--mean_std_file``).  It excludes ``--bf16``.

``--bf16`` serves every arch in the bf16 tier (``load_model_and_state(...,
bf16=True)``): the CNN computes in bfloat16 from the float32 weights, while
the featurizer (K3 + K2), the normalization, the carried ring state and the
scores stay float32.  MobileNetV1's logits view keeps the bfloat16 dtype
here, as ``sed_tpu``'s stream CLI does.

``--num_devices N`` > 1 shards the spectrogram pool's slots over N ranks,
one process per device (``parallel.multihost.launch``), with the slot count
rounded up to a multiple of N, as ``sed_tpu``'s does; every rank drives the
same loop on the same files, each rank's tick runs K3 + K2 on its slots
under ``--featurizer auto`` (``sed_tpu``'s falls back to XLA there; an
explicit 'pallas' is refused with ``sed_tpu``'s message: ROADMAP quirk Q2),
and rank 0 alone logs and writes.  M5 is refused with ``sed_tpu``'s message.  With
``--device cuda`` N may not exceed the visible cards; ``--device cpu`` runs
N gloo ranks.

Not ported yet, and refused rather than ignored: the fast/turbo featurizer
tiers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(msg: str) -> None:
    """One line on stderr, from the primary rank only."""
    from sed_tpu_torch.parallel.multihost import is_primary_host

    if is_primary_host():
        print(msg, file=sys.stderr, flush=True)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Streaming (lifecycle) sound-event scoring (PyTorch/CUDA port)")
    p.add_argument("audio_files", type=str, nargs="+")
    p.add_argument("--ckpt", type=str, required=True,
                   help="a port iteration_{n}.pt, a reference .pth or a sed_tpu .ckpt / .ckpt.orbax")
    p.add_argument("--outputs_dir", type=str, default="streaming_outputs")
    p.add_argument("--chunk_seconds", type=float, default=1.0,
                   help="chunk every stream pushes per tick")
    p.add_argument("--slots", type=int, default=0,
                   help="pool slots (0 = min(#files, 32)); files beyond the "
                        "slot count join as earlier streams leave")
    p.add_argument("--stagger_ticks", type=int, default=0,
                   help="file i may join no earlier than tick i*stagger "
                        "(0 = all join as soon as a slot is free)")
    p.add_argument("--halo", type=int, default=64,
                   help="receptive-field halo (frames, stride-aligned)")
    p.add_argument("--featurizer", type=str, default="auto",
                   help="auto|pallas: the tick featurizes through the CUDA "
                        "kernels K3 + K2; xla: in PyTorch ops")
    p.add_argument("--featurizer_precision", type=str, default="parity",
                   choices=["parity", "fast", "turbo"],
                   help="FFT precision tier of the pool's featurizer: parity "
                        "(default), fast (bf16x3) or turbo (bf16x1), the bf16 "
                        "tensor-core DFT; ignored by --featurizer xla and M5")
    p.add_argument("--num_devices", type=int, default=1,
                   help="shard the pool's slots over a data mesh of this many "
                        "devices, one rank each (slots are rounded up to a "
                        "multiple)")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="int8 serving forward (lossy), calibrated on the first file")
    p.add_argument("--mean_std_file", type=str, default="")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on: cuda (default) or cpu")
    p.add_argument("--event_threshold", type=float, default=None)
    p.add_argument("--event_min_duration", type=float, default=0.0)
    p.add_argument("--event_merge_gap", type=float, default=0.0)
    p.add_argument("--tau_labels", type=str, default="doorslam",
                   help="comma-separated event classes — must match the "
                        "checkpoint's training config")
    p.add_argument("--arch", type=str, default="CnnAvgPooling",
                   choices=["CnnAvgPooling", "MobileNetV1", "M5"],
                   help="model family: the spectrogram families stream over the "
                        "device-ring pool; M5 streams hop-strided waveform frames")
    p.add_argument("--m5_pool", choices=["device", "host"], default="device",
                   help="M5 pool: 'device' (sample rings on the card, raw chunks "
                        "uploaded; the default) or 'host' (rolling host buffers)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 forward (lossy serving tier); excludes --quantize")
    return p


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Exit on the option combinations ``sed_tpu``'s stream CLIs refuse
    (shared with ``cli.serve_socket``), with its messages: ``--num_devices``
    with M5 (sharding applies to the spectrogram pool) and ``--bf16`` with
    ``--quantize``."""
    if args.bf16 and args.quantize:
        raise SystemExit("--bf16 and --quantize are mutually exclusive "
                         "serving tiers (int8 replaces the float forward)")
    if args.arch == "M5" and getattr(args, "num_devices", 1) > 1:
        parser.error("--num_devices applies to the spectrogram pool")


def serving_config(args):
    """``WaveformConfig`` for M5, ``SpectrogramConfig`` otherwise, with the
    classes of ``--tau_labels``."""
    from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig

    labels = tuple(args.tau_labels.split(","))
    if args.arch == "M5":
        return WaveformConfig(tau_sed_labels=labels)
    return SpectrogramConfig(tau_sed_labels=labels)


def calibrate_int8(model, arch: str, cfg, wav: np.ndarray, mean=None, std=None):
    """The int8 artifact of ``model`` (on its device) calibrated on one mono
    float32 recording ``wav``: M5 on its hop-strided frames (the caller
    checks it holds one), the spectrogram archs on its log-mel features
    (K1 + K2 on the card), normalized by ``mean``/``std`` when given."""
    import torch

    from sed_tpu_torch.models import quantize as q
    from sed_tpu_torch.utils.precision import full_float32

    device = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(device)
    if arch == "M5":
        from sed_tpu_torch.cli.infer import hop_frames

        batch = hop_frames(x[:, None], cfg)
    else:
        from sed_tpu_torch.ops.featurizer import logmel_features_batch

        with torch.no_grad(), full_float32():
            batch = logmel_features_batch(x[None, :, None], cfg)
            if mean is not None:
                batch = (batch - torch.as_tensor(np.asarray(mean, np.float32), device=device)) \
                    / torch.as_tensor(np.asarray(std, np.float32), device=device)
    return q.quantize_model(model, [batch])[0]


def build_pool(args, cfg, slots: int, chunk: int, note=None, m5_ignored=(), calib_wav=None,
               mobilenet_bf16: bool = True, mesh=None):
    """The serving pool of ``args`` (shared with ``cli.serve_socket``):
    ``--ckpt`` loaded into ``--arch`` on ``--device`` (the bf16 tier under
    ``--bf16``) and the pool of its family.  MobileNetV1 is served as its
    logits view (the pool applies the sigmoid) with ``--halo`` raised to its
    receptive-field floor; the view keeps the bf16 dtype unless
    ``mobilenet_bf16`` is False (``cli.serve_socket``, whose ``sed_tpu``
    counterpart rebuilds the view in float32), and ``note`` then says so.
    M5 gets the ``--m5_pool`` pool at its default chunk of one second, as
    ``sed_tpu``'s, and ``note`` names the options it ignores (those of
    ``m5_ignored`` first).  With ``--quantize int8`` the pool scores through
    the int8 forward, calibrated on ``calib_wav`` (:func:`calibrate_int8`).
    ``mesh``: the spectrogram pool's slots sharded over its ranks, each on
    its own device."""
    from sed_tpu_torch.cli.infer import halo_floor, load_mean_std, load_model_and_state

    note = note or log
    device = args.device if mesh is None else mesh.device
    model, _ = load_model_and_state(args.ckpt, cfg, arch=args.arch, bf16=args.bf16,
                                    device=device)
    mean, std = load_mean_std(args.mean_std_file) if args.arch != "M5" else (None, None)
    qparams = None
    if args.quantize == "int8":
        qparams = calibrate_int8(model, args.arch, cfg, calib_wav, mean, std)
    if args.arch == "M5":
        from sed_tpu_torch.waveform_streaming import (DeviceWaveformStreamPool,
                                                      WaveformStreamPool)

        ignored = list(m5_ignored) + [f for f, on in (
            ("--halo", args.halo != 64),
            ("--featurizer", args.featurizer != "auto"),
            ("--featurizer_precision", args.featurizer_precision != "parity"),
            ("--mean_std_file", bool(args.mean_std_file)),
        ) if on]
        if ignored:
            note(f"note: {', '.join(ignored)} have no effect on the M5 pool")
        if args.m5_pool == "device":
            return DeviceWaveformStreamPool(model, cfg, slots=slots, qparams=qparams,
                                            device=args.device)
        return WaveformStreamPool(model, cfg, slots=slots, qparams=qparams, device=args.device)

    from sed_tpu_torch.stream_pool import StreamPool

    if args.arch == "MobileNetV1":
        from sed_tpu_torch.models.cnn import MobileNetV1

        dtype = model.dtype if mobilenet_bf16 else None
        if args.bf16 and not mobilenet_bf16:
            note("note: --bf16 serves MobileNetV1 in float32 here: its logits view is "
                 "rebuilt without the bf16 dtype, as sed_tpu's socket server does")
        logits = MobileNetV1(cfg.classes_num, emit="logits", dtype=dtype)
        logits.load_state_dict(model.state_dict(), strict=True)
        model = logits
        args.halo = halo_floor(model, args.halo, log=note)
    return StreamPool(model, cfg, slots=slots, chunk_samples=chunk, halo=args.halo,
                      mean=mean, std=std, mesh=mesh, featurizer=args.featurizer,
                      featurizer_precision=args.featurizer_precision, qparams=qparams,
                      device=device)


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    from sed_tpu_torch.parallel.multihost import run_on_devices

    run_on_devices(run, args.num_devices, args.device, (args,))


def run(args, mesh=None) -> None:
    """Read the files and stream them through the pool; under ``mesh``
    every rank runs this loop alike and rank 0 alone writes."""
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.ops import cuda_featurizer as kernels

    cfg = serving_config(args)
    chunk = int(round(args.chunk_seconds * cfg.working_sample_rate))
    primary = mesh is None or mesh.rank == 0
    if primary:
        os.makedirs(args.outputs_dir, exist_ok=True)

    # File queue: (path, mono float32 waveform).  Reading up front keeps the
    # tick loop pure feed/score; a live deployment feeds sockets here.
    queue = []
    for path in args.audio_files:
        wav = read_multichannel_audio(path, target_fs=cfg.working_sample_rate, cfg=cfg)
        queue.append({"path": path, "wav": wav[:, 0].astype(np.float32), "pos": 0,
                      "scores": []})
    slots = args.slots or min(len(queue), 32)
    if mesh is not None:
        slots = mesh.size * (-(-slots // mesh.size))
    calib = queue[0]["wav"]
    if args.quantize == "int8" and args.arch == "M5" and len(calib) < 2 * (cfg.frame_size // 2):
        raise SystemExit(f"first file is too short to calibrate int8 "
                         f"(needs >= {cfg.frame_size} samples)")
    pool = build_pool(args, cfg, slots, chunk, calib_wav=calib, mesh=mesh)
    if args.quantize == "int8":
        log(f"int8 serving mode: activation scales calibrated on {queue[0]['path']}")

    kernels.reset_launch_counts()
    active = {}           # slot -> file record
    next_file = 0
    tick = 0
    t0 = time.time()
    pushed_samples = 0
    while next_file < len(queue) or active:
        # Admit files whose stagger time has arrived, while slots are free.
        while (next_file < len(queue) and len(active) < slots
               and tick >= next_file * args.stagger_ticks):
            rec = queue[next_file]
            slot = pool.join()
            active[slot] = rec
            log(f"tick {tick}: {os.path.basename(rec['path'])} joined slot {slot}")
            next_file += 1
        if not active:  # staggered start gap with nothing live
            tick += 1
            continue

        leaving = []
        for slot, rec in active.items():
            take = min(len(rec["wav"]) - rec["pos"], chunk)
            pool.feed(slot, rec["wav"][rec["pos"]: rec["pos"] + take])
            rec["pos"] += take
            pushed_samples += take
            if rec["pos"] >= len(rec["wav"]):
                leaving.append(slot)
        # One batched device tick for every slot with a full chunk staged; a
        # file's last partial chunk drains exactly through leave_many.
        for slot, sc in pool.tick().items():
            if sc.shape[0]:
                active[slot]["scores"].append(sc)
        tails = pool.leave_many(leaving) if leaving else {}
        for slot in leaving:
            rec = active.pop(slot)
            tail = tails[slot]
            if isinstance(tail, Exception):
                raise tail
            if tail.shape[0] == 0 and len(rec["wav"]) <= getattr(cfg, "nfft", 0) // 2:
                log(f"tick {tick}: {os.path.basename(rec['path'])} too short "
                    f"to featurize; emitting empty scores")
            if tail.shape[0]:
                rec["scores"].append(tail)
            if primary:
                _finalize(rec, cfg, args)
            log(f"tick {tick}: {os.path.basename(rec['path'])} left slot {slot}")
        tick += 1

    wall = time.time() - t0
    audio_s = pushed_samples / cfg.working_sample_rate
    if not primary:
        return
    print(json.dumps({
        "files": len(queue),
        "ticks": tick,
        "audio_seconds": round(audio_s, 1),
        "wall_seconds": round(wall, 2),
        "realtime_factor": round(audio_s / wall, 1) if wall > 0 else None,
        "device": str(pool.device),
        "kernel_launches": dict(kernels.LAUNCHES),
    }))


def _finalize(rec, cfg, args) -> None:
    scores = (np.concatenate(rec["scores"], axis=0) if rec["scores"]
              else np.zeros((0, cfg.classes_num), np.float32))
    # feed()/leave_many() score exactly the real audio, so the frame count
    # already equals offline scoring's (model-stride-truncated) count.
    base = os.path.splitext(os.path.basename(rec["path"]))[0]
    np.save(os.path.join(args.outputs_dir, f"{base}_scores.npy"), scores)
    if args.event_threshold is not None:
        from sed_tpu_torch.utils.events_post import events_to_csv, extract_events

        evs = extract_events(scores, cfg.frames_per_second,
                             threshold=args.event_threshold,
                             min_duration=args.event_min_duration,
                             merge_gap=args.event_merge_gap)
        events_to_csv(evs, cfg.tau_sed_labels,
                      os.path.join(args.outputs_dir, f"{base}_events.csv"))
    rec["scores"] = None  # release


if __name__ == "__main__":
    main()

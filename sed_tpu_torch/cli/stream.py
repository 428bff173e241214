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

Not ported yet, and refused rather than ignored: ``--quantize``, ``--bf16``,
``--num_devices`` > 1 and the fast/turbo featurizer tiers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Streaming (lifecycle) sound-event scoring (PyTorch/CUDA port)")
    p.add_argument("audio_files", type=str, nargs="+")
    p.add_argument("--ckpt", type=str, required=True,
                   help="a port iteration_{n}.pt, a reference .pth or a sed_tpu .ckpt")
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
                   help="FFT precision tier; only 'parity' is ported")
    p.add_argument("--num_devices", type=int, default=1,
                   help="sharded pool: only 1 is ported")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="int8 serving: not ported")
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
                   help="bfloat16 forward: not ported")
    return p


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Exit with a usage error naming every unported option that was given
    (shared with ``cli.serve_socket``).  ``--num_devices`` with M5 gets
    ``sed_tpu``'s message: sharding applies to the spectrogram pool."""
    if args.arch == "M5" and getattr(args, "num_devices", 1) > 1:
        parser.error("--num_devices applies to the spectrogram pool")
    unported = [flag for flag, on in (
        ("--quantize", args.quantize is not None),
        ("--bf16", args.bf16),
        ("--num_devices > 1", getattr(args, "num_devices", 1) != 1),
        (f"--featurizer_precision {args.featurizer_precision}",
         args.featurizer_precision != "parity"),
    ) if on]
    if unported:
        parser.error(f"not ported yet: {', '.join(unported)} (see ROADMAP.md)")


def serving_config(args):
    """``WaveformConfig`` for M5, ``SpectrogramConfig`` otherwise, with the
    classes of ``--tau_labels``."""
    from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig

    labels = tuple(args.tau_labels.split(","))
    if args.arch == "M5":
        return WaveformConfig(tau_sed_labels=labels)
    return SpectrogramConfig(tau_sed_labels=labels)


def build_pool(args, cfg, slots: int, chunk: int, note=None, m5_ignored=()):
    """The serving pool of ``args`` (shared with ``cli.serve_socket``):
    ``--ckpt`` loaded into ``--arch`` on ``--device`` and the pool of its
    family.  MobileNetV1 is served as its logits view (the pool applies the
    sigmoid) with ``--halo`` raised to its receptive-field floor.  M5 gets
    the ``--m5_pool`` pool at its default chunk of one second, as
    ``sed_tpu``'s, and ``note`` names the options it ignores (those of
    ``m5_ignored`` first)."""
    from sed_tpu_torch.cli.infer import halo_floor, load_mean_std, load_model_and_state

    note = note or log
    model, _ = load_model_and_state(args.ckpt, cfg, arch=args.arch, device=args.device)
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
            return DeviceWaveformStreamPool(model, cfg, slots=slots, device=args.device)
        return WaveformStreamPool(model, cfg, slots=slots, device=args.device)

    from sed_tpu_torch.stream_pool import StreamPool

    if args.arch == "MobileNetV1":
        from sed_tpu_torch.models.cnn import MobileNetV1

        logits = MobileNetV1(cfg.classes_num, emit="logits")
        logits.load_state_dict(model.state_dict(), strict=True)
        model = logits
        args.halo = halo_floor(model, args.halo, log=note)
    mean, std = load_mean_std(args.mean_std_file)
    return StreamPool(model, cfg, slots=slots, chunk_samples=chunk, halo=args.halo,
                      mean=mean, std=std, featurizer=args.featurizer,
                      featurizer_precision=args.featurizer_precision, device=args.device)


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)

    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.ops import cuda_featurizer as kernels

    cfg = serving_config(args)
    chunk = int(round(args.chunk_seconds * cfg.working_sample_rate))
    os.makedirs(args.outputs_dir, exist_ok=True)

    # File queue: (path, mono float32 waveform).  Reading up front keeps the
    # tick loop pure feed/score; a live deployment feeds sockets here.
    queue = []
    for path in args.audio_files:
        wav = read_multichannel_audio(path, target_fs=cfg.working_sample_rate, cfg=cfg)
        queue.append({"path": path, "wav": wav[:, 0].astype(np.float32), "pos": 0,
                      "scores": []})
    slots = args.slots or min(len(queue), 32)
    pool = build_pool(args, cfg, slots, chunk)

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
            _finalize(rec, cfg, args)
            log(f"tick {tick}: {os.path.basename(rec['path'])} left slot {slot}")
        tick += 1

    wall = time.time() - t0
    audio_s = pushed_samples / cfg.working_sample_rate
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

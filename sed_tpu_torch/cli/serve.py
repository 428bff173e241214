"""Serving CLI: build and run AOT audio -> scores artifacts (counterpart of
``sed_tpu.cli.serve``).

``build`` loads a checkpoint and exports the whole serving graph once
(``sed_tpu_torch.export``): the ``torch.export`` program with its weights,
and for a CUDA artifact the featurizer kernels' library.  ``run`` loads it
in a fresh process and scores audio with no model classes, no compile and
no ``nvcc``, printing the load-to-first-result time.

    python -m sed_tpu_torch.cli.serve build --ckpt run/checkpoints/iteration_x.pt \\
        --out serving.aot --batch 16 --seconds 60 [--quantize int8 | --bf16]
    python -m sed_tpu_torch.cli.serve run --artifact serving.aot a.wav b.wav ...

``--ckpt`` takes a port ``.pt``, a reference ``.pth`` or a ``sed_tpu``
``.ckpt`` (``cli/infer.load_model_and_state``).  The artifact input is
(batch, samples, 1) int16 PCM; ``run`` decodes, resamples, pads or crops
each file to that length and scores the files ``batch`` at a time.  Both
run on ``--device`` (default ``cuda``); ``run`` refuses an artifact traced
for another device type.

``build --num_devices N`` (the spectrogram families) exports a sharded
artifact (``export.py``): one rank's program on ``--batch / N`` rows, built
on each of N ranks (``parallel.multihost.run_on_devices``: NCCL on the
cards, gloo with ``--device cpu``), rank 0 writing it.  ``--batch`` must
divide by N, and fewer visible cards than N are refused, with ``sed_tpu``'s
words.  ``run`` reads the artifact's device count and, above 1, runs on
that many ranks: every rank decodes the same files and scores its rows,
and rank 0 alone writes the outputs and prints the JSON line.  Not ported
yet, and refused by name: the fast/turbo featurizer tiers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from sed_tpu_torch.cli.infer import ARCHS


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AOT serving artifacts (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="export + serialize the serving graph")
    b.add_argument("--ckpt", type=str, required=True,
                   help="a port iteration_{n}.pt, a reference .pth or a sed_tpu .ckpt / .ckpt.orbax")
    b.add_argument("--out", type=str, required=True)
    b.add_argument("--arch", type=str, default="CnnAvgPooling", choices=ARCHS,
                   help="checkpoint's model family.  MobileNetV1 serves through "
                        "the featurize pipeline (its logits view, then the "
                        "head's sigmoid); M5 artifacts hop-split the PCM into "
                        "31680-sample frames and score each (featurizer flags "
                        "do not apply).  The arch is recorded in the artifact; "
                        "'run' adapts to it")
    b.add_argument("--batch", type=int, default=16)
    b.add_argument("--seconds", type=int, default=60,
                   help="audio length the artifact is exported for")
    b.add_argument("--mean_std_file", type=str, default="")
    b.add_argument("--quantize", choices=["int8"], default=None,
                   help="int8 PTQ serving graph (lossy); calibrated on synthetic "
                        "noise unless --calib_wav")
    b.add_argument("--calib_wav", type=str, nargs="*", default=[],
                   help="wav files for int8 activation calibration")
    b.add_argument("--qat_steps", type=int, default=0,
                   help="with --quantize int8: distill-fine-tune the int8 weights "
                        "against the float model on the calibration audio for this "
                        "many steps before export (models/qat.py; CnnAvgPooling)")
    b.add_argument("--qat_lr", type=float, default=3e-5)
    b.add_argument("--use_pallas", type=str, default="auto",
                   help="auto|full|off: auto and full put the hand-written "
                        "featurizer kernels (K1 + K2) in the graph; off the "
                        "PyTorch STFT and mel product")
    b.add_argument("--featurizer_precision", type=str, default="parity",
                   choices=["parity", "fast", "turbo"],
                   help="FFT precision tier baked into the artifact: 'parity' "
                        "(default), 'fast' (bf16x3) or 'turbo' (bf16x1), the bf16 "
                        "tensor-core DFT; spectrogram archs only")
    b.add_argument("--num_devices", type=int, default=1,
                   help="export a sharded artifact: each of this many ranks (one a "
                        "device) runs one program on its --batch / N rows and the "
                        "scores are gathered; 'run' then runs as many ranks")
    b.add_argument("--tau_labels", type=str, default="doorslam",
                   help="comma-separated event classes; must match the "
                        "checkpoint's training config")
    b.add_argument("--bf16", action="store_true", default=False,
                   help="bake a bfloat16 model forward into the artifact "
                        "(parameters stay float32): a lossy serving tier; "
                        "mutually exclusive with --quantize")
    b.add_argument("--device", type=str, default="cuda",
                   help="device to export for: cuda (default) or cpu")

    r = sub.add_parser("run", help="load an artifact and score audio files")
    r.add_argument("audio_files", type=str, nargs="+")
    r.add_argument("--artifact", type=str, required=True,
                   help="artifact from 'build'. TRUSTED files only: a CUDA "
                        "artifact carries a native library that loading runs")
    r.add_argument("--outputs_dir", type=str, default="serving_outputs")
    r.add_argument("--event_threshold", type=float, default=None,
                   help="also extract event intervals (frames with score >= "
                        "threshold) to <name>_events.csv")
    r.add_argument("--event_min_duration", type=float, default=0.0)
    r.add_argument("--event_merge_gap", type=float, default=0.0)
    r.add_argument("--tau_labels", type=str, default="doorslam",
                   help="comma-separated event classes (event-csv names)")
    r.add_argument("--device", type=str, default="cuda",
                   help="device to run on: cuda (default) or cpu; it must be the "
                        "device type the artifact was exported for")
    return p


def _featurize_files(paths, cfg, samples):
    """Decode + resample + fix length; returns ((n, samples, 1) int16 PCM,
    per-file real sample counts).  Files longer than the artifact's length
    are cropped (warned); shorter ones are zero-padded, and the returned
    lengths let the caller trim the scores back to the real audio."""
    from sed_tpu_torch.io.audio import read_multichannel_audio

    out = np.zeros((len(paths), samples, 1), np.int16)
    lengths = np.zeros(len(paths), np.int64)
    for i, path in enumerate(paths):
        # (samples, channels): the first channel.
        wav = np.asarray(read_multichannel_audio(
            path, target_fs=cfg.working_sample_rate, cfg=cfg))[:, 0]
        if len(wav) > samples:
            log(f"{path}: {len(wav) / cfg.working_sample_rate:.1f}s cropped "
                f"to the artifact's compiled "
                f"{samples / cfg.working_sample_rate:.1f}s")
        n = min(len(wav), samples)
        lengths[i] = n
        out[i, :n, 0] = np.clip(wav[:n] * 32768.0, -32768, 32767).astype(np.int16)
    return out, lengths


def _refuse(args) -> None:
    if args.qat_steps > 0 and args.quantize != "int8":
        raise SystemExit("--qat_steps requires --quantize int8")
    if args.bf16 and args.quantize:
        raise SystemExit("--bf16 and --quantize are mutually exclusive "
                         "serving tiers (int8 replaces the float forward)")
    if args.arch != "CnnAvgPooling" and args.qat_steps > 0:
        raise SystemExit("--qat_steps is CnnAvgPooling-only (models/qat.py)")
    if args.num_devices > 1:
        if args.arch == "M5":
            raise SystemExit("--num_devices: the sharded artifact path is "
                             "built for the spectrogram families")
        if args.batch % args.num_devices != 0:
            raise SystemExit(f"--batch {args.batch} must divide over "
                             f"--num_devices {args.num_devices}")


def build_m5_head(args, cfg, device):
    """The M5 serving head of ``args``: float32 or bfloat16 (``--bf16``), or
    int8 calibrated on ``--calib_wav`` (or seeded noise) frames."""
    import torch

    from sed_tpu_torch.cli.infer import load_model_and_state
    from sed_tpu_torch.data.events import frame_coverage_labels
    from sed_tpu_torch.export import m5_quantized_serving, m5_serving
    from sed_tpu_torch.models.quantize import quantize_m5

    model, _ = load_model_and_state(args.ckpt, cfg, arch="M5", bf16=args.bf16,
                                    device=device)
    if args.quantize != "int8":
        return m5_serving(model)
    samples = cfg.working_sample_rate * args.seconds
    if args.calib_wav:
        pcm, _ = _featurize_files(args.calib_wav, cfg, samples)
        wav = pcm[:, :, 0].astype(np.float32) / 32768.0
    else:
        rng = np.random.default_rng(0)
        wav = (rng.standard_normal((2, samples)) * 0.12).astype(np.float32)
        log("int8 calibration on synthetic noise (pass --calib_wav for "
            "representative audio)")
    wins = np.concatenate([frame_coverage_labels(w[None], [], [], cfg)[0] for w in wav])
    calib = torch.from_numpy(wins[:: max(1, len(wins) // 256)]).to(device)  # (N, 1, frame)
    return m5_quantized_serving(quantize_m5(model, [calib]))


def build_cnn_head(args, cfg, device):
    """The spectrogram family's serving head of ``args`` (CnnAvgPooling or
    MobileNetV1): float32 or bfloat16, or int8 calibrated on the log-mel
    features of ``--calib_wav`` (or seeded noise), optionally QAT
    fine-tuned; normalized by ``--mean_std_file``."""
    import torch

    from sed_tpu_torch.cli.infer import load_mean_std, load_model_and_state
    from sed_tpu_torch.export import (cnn_serving, mobilenet_quantized_serving,
                                      quantized_serving)
    from sed_tpu_torch.ops.featurizer import logmel_features_batch

    model, _ = load_model_and_state(args.ckpt, cfg, arch=args.arch, bf16=args.bf16,
                                    device=device)
    if args.arch == "MobileNetV1":
        # The logits view of the same weights; the head applies the sigmoid.
        # sed_tpu builds the view as a new float32 module, which drops
        # --bf16; so does the port, as cli.serve_socket does.
        from sed_tpu_torch.models.cnn import MobileNetV1

        if args.bf16:
            log("note: --bf16 serves MobileNetV1 in float32 here: its logits view is "
                "rebuilt without the bf16 dtype, as sed_tpu's serve build does")
        logits = MobileNetV1(cfg.classes_num, emit="logits").to(device)
        logits.load_state_dict(model.state_dict(), strict=True)
        model = logits
    mean, std = load_mean_std(args.mean_std_file)
    if args.quantize != "int8":
        return cnn_serving(model, mean, std)
    from sed_tpu_torch.models import quantize as q

    samples = cfg.working_sample_rate * args.seconds
    if args.calib_wav:
        pcm, _ = _featurize_files(args.calib_wav, cfg, samples)
    else:
        rng = np.random.default_rng(0)
        pcm = (rng.standard_normal((2, samples, 1)) * 4000).astype(np.int16)
        log("int8 calibration on synthetic noise (pass --calib_wav for "
            "representative audio)")
    with torch.inference_mode():
        feats = logmel_features_batch(torch.from_numpy(pcm).to(device), cfg)
        if mean is not None:
            feats = (feats - torch.as_tensor(np.asarray(mean, np.float32), device=device)) \
                / torch.as_tensor(np.asarray(std, np.float32), device=device)
    calib = [feats.clone()]
    if args.qat_steps > 0:
        from sed_tpu_torch.models.qat import qat_export, qat_finetune, qat_init
        from sed_tpu_torch.train.state import make_eval_forward

        trainable, static = qat_init(model, calib)
        forward = make_eval_forward(model)
        # qat_finetune takes host arrays: (features, the float model's logits).
        examples = [(x.cpu().numpy(), forward(x).cpu().numpy()) for x in calib]
        trainable = qat_finetune(trainable, static, examples, mode="distill",
                                 steps=args.qat_steps, lr=args.qat_lr, device=device)
        log(f"QAT: {args.qat_steps} distill steps on the calibration audio before "
            "int8 export")
        return quantized_serving(qat_export(trainable, static), mean, std)
    if args.arch == "MobileNetV1":
        return mobilenet_quantized_serving(q.quantize_mobilenet(model, calib), mean, std)
    return quantized_serving(q.quantize_cnn(model, calib), mean, std)


def build_head(args, device):
    """``(head, cfg)`` for ``args``: the module ``build`` exports."""
    from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig

    labels = tuple(args.tau_labels.split(","))
    if args.arch == "M5":
        cfg = WaveformConfig(tau_sed_labels=labels)
        return build_m5_head(args, cfg, device), cfg
    cfg = SpectrogramConfig(tau_sed_labels=labels)
    return build_cnn_head(args, cfg, device), cfg


def cmd_build(args) -> None:
    from sed_tpu_torch.parallel.multihost import run_on_devices

    _refuse(args)
    run_on_devices(build, args.num_devices, args.device, (args,))


def build(args, mesh=None) -> None:
    """Export ``args``' artifact on ``args.device`` or, under ``mesh``, its
    sharded artifact on this rank's device; rank 0 alone writes it."""
    from sed_tpu_torch.export import aot_export_m5_pipeline, aot_export_pipeline
    from sed_tpu_torch.inference import resolve_device

    device = resolve_device(args.device) if mesh is None else mesh.device
    t0 = time.time()
    head, cfg = build_head(args, device)
    samples = cfg.working_sample_rate * args.seconds
    meta = {"arch": args.arch}
    if args.bf16:
        meta["dtype"] = "bfloat16"   # informational: the program computes in it
    if args.arch != "M5":
        meta["featurizer_precision"] = args.featurizer_precision   # informational
    if args.arch == "M5":
        blob = aot_export_m5_pipeline(head, args.batch, samples, cfg, meta=meta,
                                      device=device)
    else:
        use_pallas = False if args.use_pallas == "off" else args.use_pallas
        blob = aot_export_pipeline(head, args.batch, samples, cfg, use_pallas=use_pallas,
                                   mesh=mesh, featurizer_precision=args.featurizer_precision,
                                   meta=meta, device=device)
    build_s = time.time() - t0
    if mesh is not None and mesh.rank:
        return
    with open(args.out, "wb") as f:
        f.write(blob)
    log(f"built {args.out}: {len(blob) / 1e6:.1f} MB in {build_s:.1f}s "
        f"(exported once here; loading runs no compile and no nvcc)")
    summary = {"artifact": args.out, "bytes": len(blob), "build_seconds": round(build_s, 1),
               "arch": args.arch, "batch": args.batch, "seconds": args.seconds,
               "quantize": args.quantize}
    if args.arch != "M5":
        summary.update(qat_steps=args.qat_steps,
                       featurizer_precision=args.featurizer_precision,
                       num_devices=args.num_devices)
    print(json.dumps(summary))


def frames_of(arch: str, n_samples: int, cfg) -> int:
    """Frames of real audio in ``n_samples``: the spectrogram families'
    centred-STFT count, 1 + n // hop; M5's hop-split window count,
    (n - frame) // hop + 1 (0 below one frame)."""
    if arch == "M5":
        return (n_samples - cfg.frame_size) // cfg.hop_size + 1 \
            if n_samples >= cfg.frame_size else 0
    return 1 + n_samples // cfg.hop_size


def cmd_run(args) -> None:
    from sed_tpu_torch.export import artifact_devices
    from sed_tpu_torch.parallel.multihost import run_on_devices

    with open(args.artifact, "rb") as f:
        n_devices = artifact_devices(f.read(), args.device)
    run_on_devices(run, n_devices, args.device, (args,))


def run(args, mesh=None) -> None:
    """Score ``args.audio_files`` with the artifact on ``args.device`` or,
    under ``mesh``, this rank's rows of each batch on its device (every rank
    decodes the same files); rank 0 alone writes the outputs."""
    from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
    from sed_tpu_torch.export import load_aot_pipeline

    primary = mesh is None or mesh.rank == 0
    t_load0 = time.time()
    with open(args.artifact, "rb") as f:
        call = load_aot_pipeline(f.read(), device=args.device, mesh=mesh)  # trusted only
    t_loaded = time.time()
    if primary:
        log("load stages (s): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in call.load_timings.items()))
    batch, samples, _ = call.input_shape
    arch = call.meta.get("arch", "CnnAvgPooling")
    labels = tuple(args.tau_labels.split(","))
    cfg = (WaveformConfig(tau_sed_labels=labels) if arch == "M5"
           else SpectrogramConfig(tau_sed_labels=labels))

    if primary:
        os.makedirs(args.outputs_dir, exist_ok=True)
    first_result_s = None
    for lo in range(0, len(args.audio_files), batch):
        group = args.audio_files[lo:lo + batch]
        pcm = np.zeros((batch, samples, 1), np.int16)
        pcm[: len(group)], lengths = _featurize_files(group, cfg, samples)
        scores = np.asarray(call(pcm))
        if first_result_s is None:
            first_result_s = time.time() - t_load0
        if not primary:
            continue
        for i, path in enumerate(group):
            # The frames scored over the zero-padded tail are trimmed.
            s = scores[i, :min(scores.shape[1], frames_of(arch, int(lengths[i]), cfg))]
            base = os.path.splitext(os.path.basename(path))[0]
            np.save(os.path.join(args.outputs_dir, f"{base}_scores.npy"), s)
            if args.event_threshold is not None:
                from sed_tpu_torch.utils.events_post import events_to_csv, extract_events

                evs = extract_events(s, cfg.frames_per_second,
                                     threshold=args.event_threshold,
                                     min_duration=args.event_min_duration,
                                     merge_gap=args.event_merge_gap)
                events_to_csv(evs, cfg.tau_sed_labels, os.path.join(
                    args.outputs_dir, f"{base}_events.csv"))
            log(f"{path}: frames={s.shape[0]}, max score={s.max():.3f}" if s.size else
                f"{path}: shorter than one frame — 0 scores")
    if not primary:
        return
    print(json.dumps({
        "artifact_load_seconds": round(t_loaded - t_load0, 2),
        "load_to_first_result_seconds": round(first_result_s, 2),
        "files": len(args.audio_files),
    }))


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    if args.cmd == "build":
        cmd_build(args)
    else:
        cmd_run(args)


if __name__ == "__main__":
    main()

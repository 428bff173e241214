"""Inference CLI: per-frame event scores for audio files (counterpart of
``sed_tpu.cli.infer``, ``--batch`` CnnAvgPooling path).

    python -m sed_tpu_torch.cli.infer --batch --ckpt model.pth a.wav b.wav

Loads a ``.pth`` holding the reference container ``{'model': state_dict,
...}`` (what ``python -m sed_tpu.cli.export_torch`` writes) or a bare state
dict into ``CnnAvgPooling(TRAIN_CHANNEL_AND_POOL)``, scores the files in
length groups on ``--device`` (default ``cuda``), and writes
``{name}_scores.npy``, ``{name}_scores.csv`` and, with ``--event_threshold``,
``{name}_events.csv`` to ``--outputs_dir``.  No plot is drawn.

Not ported yet, and refused rather than ignored: the windowed per-file path
(no ``--batch``, ``--window``/``--halo``), ``--quantize``, ``--bf16``, the
other archs, ``--num_devices`` > 1 and the fast/turbo featurizer tiers.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Sound-event-detection inference "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("audio_files", type=str, nargs="+")
    parser.add_argument("--ckpt", type=str, required=True,
                        help=".pth with {'model': state_dict} or a bare state dict")
    parser.add_argument("--outputs_dir", type=str, default="inference_outputs")
    parser.add_argument("--mean_std_file", type=str, default="",
                        help="optional normalization stats from preprocessing; "
                             "raw log-mel features are used when absent")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on: cuda (default) or cpu")
    parser.add_argument("--batch", action="store_true", default=False,
                        help="score files as batches grouped by length "
                             "(the only path ported so far; required)")
    parser.add_argument("--window", type=int, default=None,
                        help="windowed per-file path: not ported")
    parser.add_argument("--halo", type=int, default=None,
                        help="windowed per-file path: not ported")
    parser.add_argument("--no_plot", action="store_true", default=False,
                        help="accepted for compatibility; the port draws no plot")
    parser.add_argument("--featurizer_precision", type=str, default="parity",
                        help="FFT precision tier; only 'parity' is ported")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="int8 serving: not ported")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bfloat16 forward: not ported")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="data-parallel devices: only 1 is ported")
    parser.add_argument("--arch", type=str, default="CnnAvgPooling",
                        help="model family; only CnnAvgPooling is ported")
    parser.add_argument("--event_threshold", type=float, default=None,
                        help="also extract event intervals (frames with "
                             "score >= threshold) to <name>_events.csv")
    parser.add_argument("--event_min_duration", type=float, default=0.0,
                        help="drop events shorter than this many seconds")
    parser.add_argument("--event_merge_gap", type=float, default=0.0,
                        help="merge events separated by less than this many seconds")
    parser.add_argument("--tau_labels", type=str, default="doorslam",
                        help="comma-separated event classes — must match the "
                             "checkpoint's training config")
    return parser


def _refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    unported = [flag for flag, on in (
        ("the windowed per-file path (run with --batch)", not args.batch),
        ("--window", args.window is not None),
        ("--halo", args.halo is not None),
        ("--quantize", args.quantize is not None),
        ("--bf16", args.bf16),
        ("--num_devices > 1", args.num_devices != 1),
        (f"--arch {args.arch}", args.arch != "CnnAvgPooling"),
        (f"--featurizer_precision {args.featurizer_precision}",
         args.featurizer_precision != "parity"),
    ) if on]
    if unported:
        parser.error(f"not ported yet: {', '.join(unported)} (see ROADMAP.md)")


def load_model(ckpt_path: str, classes_num: int):
    """CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) with the weights of ``ckpt_path``."""
    import torch

    from sed_tpu_torch.models.cnn import CnnAvgPooling, TRAIN_CHANNEL_AND_POOL

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    model = CnnAvgPooling(classes_num, TRAIN_CHANNEL_AND_POOL)
    model.load_state_dict(state_dict, strict=True)
    return model


def load_mean_std(path: str):
    """(mean, std) from a preprocessing pickle, or (None, None)."""
    if not path:
        return None, None
    import pickle

    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["mean"], d["std"]


def write_outputs(scores: np.ndarray, audio_file: str, args, cfg) -> None:
    """``{base}_scores.npy``, ``{base}_scores.csv`` and, with
    ``--event_threshold``, ``{base}_events.csv``."""
    base = os.path.splitext(os.path.basename(audio_file))[0]
    np.save(os.path.join(args.outputs_dir, f"{base}_scores.npy"), scores)
    with open(os.path.join(args.outputs_dir, f"{base}_scores.csv"), "w") as f:
        # time_sec uses the reference's integer frames_per_second (fs//hop).
        f.write("frame,time_sec," + ",".join(cfg.tau_sed_labels) + "\n")
        for i, row in enumerate(scores):
            vals = ",".join(f"{v:.6f}" for v in row)
            f.write(f"{i},{i / cfg.frames_per_second:.3f},{vals}\n")
    if args.event_threshold is not None:
        from sed_tpu_torch.utils.events_post import events_to_csv, extract_events

        evs = extract_events(scores, cfg.frames_per_second,
                             threshold=args.event_threshold,
                             min_duration=args.event_min_duration,
                             merge_gap=args.event_merge_gap)
        events_to_csv(evs, cfg.tau_sed_labels,
                      os.path.join(args.outputs_dir, f"{base}_events.csv"))
        print(f"  events (score >= {args.event_threshold}): "
              f"{sum(len(e) for e in evs)}")


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)

    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.inference import batch_predict_files

    cfg = SpectrogramConfig(tau_sed_labels=tuple(args.tau_labels.split(",")))
    mean, std = load_mean_std(args.mean_std_file)
    model = load_model(args.ckpt, cfg.classes_num)
    os.makedirs(args.outputs_dir, exist_ok=True)
    batch_scores = batch_predict_files(model, args.audio_files, cfg, mean=mean,
                                       std=std, device=args.device)
    for audio_file in args.audio_files:
        print(f"Processing {audio_file}")
        scores = batch_scores[audio_file]
        write_outputs(scores, audio_file, args, cfg)
        mx = float(scores.max()) if scores.size else float("nan")
        print(f"  frames={scores.shape[0]}, max score={mx:.3f}")


if __name__ == "__main__":
    main()

"""Inference CLI: per-frame event scores for audio files (counterpart of
``sed_tpu.cli.infer``).

    python -m sed_tpu_torch.cli.infer --ckpt model.pth long_recording.wav
    python -m sed_tpu_torch.cli.infer --batch --ckpt model.pth a.wav b.wav
    python -m sed_tpu_torch.cli.infer --arch M5 --ckpt m5.pth a.wav

Loads ``--ckpt`` through :func:`load_model_and_state` into ``--arch``
(CnnAvgPooling(TRAIN_CHANNEL_AND_POOL), MobileNetV1 or M5): a port
``iteration_{n}.pt``, a reference ``.pth`` (the container ``{'model':
state_dict, ...}`` or a bare state dict) or a ``sed_tpu`` msgpack ``.ckpt``
or orbax ``.ckpt.orbax``.  It scores on ``--device`` (default ``cuda``):

  * the spectrogram archs, by default one file at a time: featurize the
    whole recording on the card (K1 + K2), then an exact windowed forward
    over ``--window`` frames with ``--halo`` frames of context on each side
    (raised to the model's receptive-field floor when smaller);
  * the spectrogram archs with ``--batch``: files grouped by length, one
    batched pass per group;
  * M5: the hop-strided 31680-sample frames of each file, framed on the
    card and scored in buckets of 32 frames.

``--quantize int8`` scores the per-file paths through the int8 forward
(``models/quantize.py``), calibrated on the file itself: the spectrogram
archs on a strided subsample of its features spanning the whole file, M5
on a strided subsample of its frames.  With ``--batch`` it has no effect
(a note says so; the batch path scores in float), and it excludes
``--bf16``, the bfloat16 forward (float32 parameters and statistics,
``models/cnn.py``) on every path.

Writes ``{name}_scores.npy``, ``{name}_scores.csv``, with
``--event_threshold`` ``{name}_events.csv``, and for the spectrogram archs
without ``--no_plot`` a ``{name}.png`` (this needs matplotlib) to
``--outputs_dir``.

``--num_devices N`` > 1 (with ``--batch``) shards each length group's
batch over N ranks, one process per device (``parallel.multihost.launch``:
spawned here, or the ranks ``torchrun`` started), as ``sed_tpu``'s mesh
does; rank 0 writes the outputs.  With ``--device cuda`` N may not exceed
the visible cards; ``--device cpu`` runs N gloo ranks.

Not ported yet, and refused by name rather than ignored: the fast/turbo
featurizer tiers.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

ARCHS = ("CnnAvgPooling", "MobileNetV1", "M5")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Sound-event-detection inference "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("audio_files", type=str, nargs="+")
    parser.add_argument("--ckpt", type=str, required=True,
                        help="a port iteration_{n}.pt, a reference .pth ({'model': "
                             "state_dict} or a bare state dict) or a sed_tpu .ckpt / .ckpt.orbax")
    parser.add_argument("--outputs_dir", type=str, default="inference_outputs")
    parser.add_argument("--mean_std_file", type=str, default="",
                        help="optional normalization stats from preprocessing; "
                             "raw log-mel features are used when absent")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on: cuda (default) or cpu")
    parser.add_argument("--window", type=int, default=1024,
                        help="time-axis window (frames) for very long recordings")
    parser.add_argument("--halo", type=int, default=64,
                        help="context frames on each side of a window (raised "
                             "to the model's receptive-field floor)")
    parser.add_argument("--no_plot", action="store_true", default=False)
    parser.add_argument("--featurizer_precision", type=str, default="parity",
                        choices=["parity", "fast", "turbo"],
                        help="FFT precision tier; only 'parity' is ported")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="int8 serving forward (lossy), calibrated on each "
                             "file; the per-file paths only")
    parser.add_argument("--batch", action="store_true", default=False,
                        help="score files as batches grouped by length "
                             "(fastest for many equal-length clips)")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="with --batch: shard each group's batch over this "
                             "many devices, one rank each (groups are padded)")
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
    parser.add_argument("--arch", type=str, default="CnnAvgPooling", choices=ARCHS,
                        help="model family the checkpoint was trained with "
                             "(M5 = waveform path: one score per hop-strided "
                             "31680-sample frame)")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="compute the model forward in bfloat16 (parameters "
                             "stay float32): a lossy serving tier, not the parity "
                             "path")
    return parser


def _refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    unported = [flag for flag, on in (
        (f"--featurizer_precision {args.featurizer_precision}",
         args.featurizer_precision != "parity"),
    ) if on]
    if unported:
        parser.error(f"not ported yet: {', '.join(unported)} (see ROADMAP.md)")


def build_model(arch: str, classes_num: int, dtype=None):
    """A fresh model of family ``arch``: CnnAvgPooling(TRAIN_CHANNEL_AND_POOL),
    MobileNetV1 (scores-emitting, the reference's forward) or M5, computing
    in ``dtype`` (None: the input's; ``torch.bfloat16``: the bf16 tier)."""
    from sed_tpu_torch.models.cnn import CnnAvgPooling, MobileNetV1, TRAIN_CHANNEL_AND_POOL
    from sed_tpu_torch.models.m5 import M5

    constructors = {
        "CnnAvgPooling": lambda: CnnAvgPooling(classes_num, TRAIN_CHANNEL_AND_POOL,
                                               dtype=dtype),
        "MobileNetV1": lambda: MobileNetV1(classes_num, dtype=dtype),
        "M5": lambda: M5(classes_num, dtype=dtype),
    }
    if arch not in constructors:
        raise ValueError(f"unknown arch {arch!r}")
    return constructors[arch]()


def load_model(ckpt_path: str, classes_num: int, arch: str = "CnnAvgPooling"):
    """A model of family ``arch`` (CnnAvgPooling is TRAIN_CHANNEL_AND_POOL)
    with the weights of the ``.pth``/``.pt`` file ``ckpt_path`` (reference
    keys, ``strict=True``)."""
    import torch

    model = build_model(arch, classes_num)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    model.load_state_dict(state_dict, strict=True)
    return model


def load_model_and_state(ckpt_path: str, cfg, batch_hint: int = 1,
                         arch: str = "CnnAvgPooling", bf16: bool = False,
                         device="cuda"):
    """``(model, state)``: a model of family ``arch`` on ``device`` with the
    weights of ``ckpt_path`` (``strict=True``), and a ``TrainState`` around
    it with a fresh optimizer at step 0, the model-only load ``sed_tpu``
    makes (its counterpart, ``sed_tpu/cli/infer.py``).

    ``ckpt_path`` is a port ``iteration_{n}.pt``, a reference ``.pth``
    (``{'model': state_dict, ...}`` or a bare state dict) or a ``sed_tpu``
    msgpack ``.ckpt`` or orbax ``.ckpt.orbax``
    (:func:`sed_tpu_torch.train.checkpoint.read_model_weights`),
    so a user can pass the same file to either package's CLI.
    ``batch_hint`` sized ``sed_tpu``'s init input; the port's modules need
    none, so it is unused.  ``bf16=True`` builds the bf16 serving tier:
    the forward computes in bfloat16, the weights and statistics stay
    float32 and the logits return as float32 (flax's ``dtype``).
    """
    import torch

    from sed_tpu_torch.inference import resolve_device
    from sed_tpu_torch.train.checkpoint import read_model_weights
    from sed_tpu_torch.train.state import init_state

    device = resolve_device(device)
    model = build_model(arch, cfg.classes_num, torch.bfloat16 if bf16 else None)
    state_dict, _ = read_model_weights(ckpt_path, arch)
    model.load_state_dict(state_dict, strict=True)
    state = init_state(model, 1e-6, device)
    return state.model, state


def load_mean_std(path: str):
    """(mean, std) from a preprocessing pickle, or (None, None)."""
    if not path:
        return None, None
    import pickle

    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["mean"], d["std"]


def halo_floor(model, halo: int, log=print) -> int:
    """``halo`` raised to the model's receptive-field floor,
    8 * ceil((rf // 2 + 1) / 8), with a message to ``log`` when it is
    raised.

    CnnAvgPooling's receptive field comes from its ``model_config``,
    MobileNetV1's is fixed; any other model has no windowed path."""
    from sed_tpu_torch.models.cnn import MobileNetV1, mobilenet_receptive_field
    from sed_tpu_torch.parallel.time_shard import receptive_field

    if hasattr(model, "model_config"):
        rf = receptive_field(model.model_config)
    elif isinstance(model, MobileNetV1):
        rf = mobilenet_receptive_field()
    else:
        raise ValueError(f"{type(model).__name__} has no windowed spectrogram path; "
                         f"expected CnnAvgPooling or MobileNetV1")
    min_halo = 8 * (-(-(rf // 2 + 1) // 8))
    if halo < min_halo:
        log(f"halo {halo} < receptive field requirement {min_halo}; using {min_halo}")
        halo = min_halo
    return halo


def _stage_timer(device, timings):
    """``stage(name)``: with a ``timings`` dict, store the seconds since the
    previous stage (or since this call) under ``name``, after synchronizing
    ``device``; without one, do nothing."""
    if timings is None:
        return lambda name: None
    import time

    import torch

    last = [time.perf_counter()]

    def stage(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[name] = now - last[0]
        last[0] = now

    return stage


def predict_file(model, audio_path: str, cfg, mean=None, std=None, window: int = 1024,
                 halo: int = 64, quantize=None, featurizer_precision=None, device="cuda",
                 timings=None):
    """Read one file, featurize it on ``device`` and score every frame.

    Returns (log_mel (channels, frames, mel) tensor on ``device``, scores
    (frames', classes) numpy).  CnnAvgPooling's logits go through a sigmoid;
    MobileNetV1 emits scores itself.  ``quantize='int8'`` scores with the
    int8 forward, calibrated over the whole file (every
    ``frames // 2048``-th frame, not a prefix: a prefix would clip loud
    events later in a long recording).  One K1 and one K2 launch per call on
    CUDA; the scores stay on the card until the end.  ``timings``: a dict
    that receives the seconds of this call's stages, ``read`` (the WAV),
    ``featurizer`` (the float32 cast, upload, K1 + K2, normalization) and
    ``model`` (the windowed forward and the scores to the host).
    """
    import torch

    from sed_tpu_torch.inference import emits_scores, resolve_device
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.ops.featurizer import logmel_features, resolve_featurizer_precision
    from sed_tpu_torch.parallel.time_shard import windowed_forward
    from sed_tpu_torch.utils.precision import full_float32

    resolve_featurizer_precision(featurizer_precision)
    device = resolve_device(device)
    model = model.to(device).eval()
    halo = halo_floor(model, halo)
    stage = _stage_timer(device, timings)
    wav = read_multichannel_audio(audio_path, target_fs=cfg.working_sample_rate, cfg=cfg)
    stage("read")
    with torch.inference_mode(), full_float32():
        log_mel = logmel_features(torch.from_numpy(wav.astype(np.float32)).to(device), cfg,
                                  "auto", "auto", featurizer_precision)
        feats = log_mel
        if mean is not None:
            feats = (log_mel - torch.as_tensor(np.asarray(mean, np.float32), device=device)) \
                / torch.as_tensor(np.asarray(std, np.float32), device=device)
        stage("featurizer")
        x = feats[None]
        forward = model
        if quantize == "int8":
            from sed_tpu_torch.models import quantize as q

            qp, q_forward = q.quantize_model(model, [x[:, :, ::max(1, x.shape[2] // 2048)]])
            forward = lambda b: q_forward(qp, b)  # noqa: E731
        out = windowed_forward(forward, x, window=window, halo=halo)[0]
        scores = (out if emits_scores(model) else torch.sigmoid(out)).cpu().numpy()
    stage("model")
    return log_mel, scores


def hop_frames(waveform, cfg):
    """(samples, channels) tensor -> (n, channels, frame) view of its
    hop-strided frames, starting at 0, hop, 2 * hop, ...

    These are the frames of ``frame_coverage_labels`` in ``sed_tpu``'s
    ``data/events.py``, whose centres are these starts plus frame // 2;
    ``unfold`` makes them on the tensor's device without a copy.
    """
    width = 2 * (cfg.frame_size // 2)
    if waveform.shape[0] < width:
        return waveform.new_zeros((0, waveform.shape[1], width))
    return waveform.T.unfold(1, width, cfg.hop_size).transpose(0, 1)


def score_frames_m5(model, frames, frame_bucket: int = 32):
    """Sigmoid scores (n, classes) of (n, channels, frame) frames by
    ``model`` (M5, or with frames any callable of its logits), scored in
    batches of ``frame_bucket`` frames (the last one holds the rest)."""
    import torch

    if frames.shape[0] == 0:
        return frames.new_zeros((0, model.fc.out_features))
    with torch.inference_mode():
        return torch.cat([torch.sigmoid(model(frames[i:i + frame_bucket].contiguous()))
                          for i in range(0, frames.shape[0], frame_bucket)])


def predict_file_m5(model, audio_path: str, cfg, quantize=None, frame_bucket: int = 32,
                    device="cuda", timings=None):
    """Waveform-path inference: the file's hop-strided frames (the offline
    validation split) scored independently by M5, one sigmoid confidence per
    frame and class.  The waveform is uploaded once and framed on
    ``device``.  ``quantize='int8'`` scores with the int8 forward,
    calibrated on every ``frames // 256``-th frame.  Returns (frames,
    classes) numpy scores.  ``timings``: as for :func:`predict_file`, with
    ``featurizer`` the float32 cast, upload and framing."""
    import torch

    from sed_tpu_torch.inference import resolve_device
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.utils.precision import full_float32

    device = resolve_device(device)
    model = model.to(device).eval()
    stage = _stage_timer(device, timings)
    wav = read_multichannel_audio(audio_path, target_fs=cfg.working_sample_rate, cfg=cfg)
    stage("read")
    frames = hop_frames(torch.from_numpy(wav.astype(np.float32)).to(device), cfg)
    stage("featurizer")
    forward = model
    if quantize == "int8" and frames.shape[0]:
        from sed_tpu_torch.models.quantize import quantize_model

        qp, q_forward = quantize_model(model, [frames[::max(1, frames.shape[0] // 256)]])
        forward = lambda b: q_forward(qp, b)  # noqa: E731
    with full_float32():
        scores = score_frames_m5(forward, frames, frame_bucket).cpu().numpy()
    stage("model")
    return scores


def write_outputs(scores: np.ndarray, audio_file: str, args, cfg) -> None:
    """``{base}_scores.npy``, ``{base}_scores.csv`` and, with
    ``--event_threshold``, ``{base}_events.csv``."""
    base = os.path.splitext(os.path.basename(audio_file))[0]
    np.save(os.path.join(args.outputs_dir, f"{base}_scores.npy"), scores)
    with open(os.path.join(args.outputs_dir, f"{base}_scores.csv"), "w") as f:
        # time_sec uses the reference's integer frames_per_second (fs//hop)
        # for every arch.
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
    if args.num_devices > 1 and not args.batch:
        parser.error("--num_devices shards the batched path; add --batch")
    if args.bf16 and args.quantize:
        raise SystemExit("--bf16 and --quantize are mutually exclusive "
                         "serving tiers (int8 replaces the float forward)")
    _refuse_unported(parser, args)

    from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig

    labels = tuple(args.tau_labels.split(","))
    if args.arch == "M5":
        cfg = WaveformConfig(tau_sed_labels=labels)
        if args.batch:
            parser.error("--batch applies to the spectrogram archs; the M5 "
                         "path already scores all frames of a file batched")
        ignored = [f for f, on in (
            ("--mean_std_file", bool(args.mean_std_file)),
            ("--featurizer_precision", args.featurizer_precision != "parity"),
            ("--window", args.window != 1024),
            ("--halo", args.halo != 64),
        ) if on]
        if ignored:
            print(f"note: {', '.join(ignored)} have no effect on the M5 "
                  f"waveform path (no featurizer, frames scored whole)")
    else:
        cfg = SpectrogramConfig(tau_sed_labels=labels)
        if not args.no_plot:
            from sed_tpu_torch.utils.plotting import require_matplotlib

            try:
                require_matplotlib()
            except RuntimeError as e:
                parser.error(str(e))

    from sed_tpu_torch.parallel.multihost import run_on_devices

    run_on_devices(run, args.num_devices, args.device, (args, cfg))


def run(args, cfg, mesh=None) -> None:
    """Load the model and score every file on ``args.device`` or, under
    ``mesh``, this rank's shard of each ``--batch`` group on its device;
    rank 0 alone writes the outputs."""
    import torch

    from sed_tpu_torch.inference import resolve_device

    device = resolve_device(args.device) if mesh is None else mesh.device
    primary = mesh is None or mesh.rank == 0
    mean, std = load_mean_std(args.mean_std_file)
    model, _ = load_model_and_state(args.ckpt, cfg, arch=args.arch, bf16=args.bf16,
                                    device=device)
    if primary:
        os.makedirs(args.outputs_dir, exist_ok=True)

    batch_scores = None
    if args.batch:
        if args.quantize and primary:
            print("--quantize applies to the per-file windowed path; "
                  "--batch uses the float forward")
        from sed_tpu_torch.inference import batch_predict_files

        batch_scores = batch_predict_files(model, args.audio_files, cfg, mean=mean,
                                           std=std, device=device, mesh=mesh)
    if not primary:
        return

    for audio_file in args.audio_files:
        print(f"Processing {audio_file}")
        log_mel = None
        if batch_scores is not None:
            scores = batch_scores[audio_file]
            if not args.no_plot:  # features re-derived only when a plot needs them
                from sed_tpu_torch.io.audio import read_multichannel_audio
                from sed_tpu_torch.ops.featurizer import logmel_features

                wav = read_multichannel_audio(audio_file, target_fs=cfg.working_sample_rate,
                                              cfg=cfg)
                with torch.inference_mode():
                    log_mel = logmel_features(
                        torch.from_numpy(wav.astype(np.float32)).to(device), cfg)
        elif args.arch == "M5":
            scores = predict_file_m5(model, audio_file, cfg, quantize=args.quantize,
                                     device=device)
        else:
            log_mel, scores = predict_file(model, audio_file, cfg, mean, std,
                                           window=args.window, halo=args.halo,
                                           quantize=args.quantize, device=device)
        write_outputs(scores, audio_file, args, cfg)
        if not args.no_plot and log_mel is not None:
            from sed_tpu_torch.utils.plotting import plot_sample_features

            base = os.path.splitext(os.path.basename(audio_file))[0]
            plot_sample_features(log_mel.cpu().numpy(), mode="spectogram", output=scores,
                                 file_name=base,
                                 plot_path=os.path.join(args.outputs_dir, f"{base}.png"),
                                 cfg=cfg)
        mx = float(scores.max()) if scores.size else float("nan")
        print(f"  frames={scores.shape[0]}, max score={mx:.3f}")


if __name__ == "__main__":
    main()

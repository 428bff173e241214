"""Training CLI with the reference's flag surface (counterpart of
``sed_tpu.cli.main``; reference main.py:85-141).

    python -m sed_tpu_torch.cli.main --dataset_dir data --dataset_name FilmClap
    python -m sed_tpu_torch.cli.main --train_features Spectogram \\
        --dataset_dir data --dataset_name FilmClap --model CnnAvgPooling

Trains M5 on raw waveform frames (``--train_features Waveform``, the
default) or the spectrogram family (CnnAvgPooling(TRAIN_CHANNEL_AND_POOL),
or MobileNetV1 emitting logits) on ``--device`` (default ``cuda``; ``cpu``
runs the plain versions of the kernels).  Checkpoints are the port's
``checkpoints/iteration_{n}.pt``; ``--ckpt`` restores the weights only, like
the reference resume (main.py:37-39), ``--resume auto`` the full state of
the run's latest checkpoint.  Both also read ``sed_tpu``'s msgpack
``iteration_{n}.ckpt`` (``train/checkpoint.load_checkpoint``), so a run
started under ``sed_tpu`` continues here.  ``--steps_per_call K`` runs K steps a call,
``--profile_dir`` writes a profiler trace of steps 10-20.  ``--no_plot``
(the port's addition) skips the PNGs, which need matplotlib; metrics.jsonl
is written either way.

``--bf16`` trains CnnAvgPooling and M5 with their compute in bfloat16
(``models.layers``): parameters, optimizer state, BatchNorm statistics and
checkpoints stay float32, and the logits, loss, augmentation and metrics
float32; MobileNetV1 refuses it with ``sed_tpu``'s ``ValueError``.
``--preprocess_workers N`` reads the WAVs on N threads of the native reader
(``io/native.py``): the logMel/Complex preprocessing pipelines its reads
ahead of the featurizer, and the waveform dataset loads its files in one
batch.

``--num_devices N`` > 1 trains data-parallel on N ranks, one process per
device (``parallel.multihost.launch``): spawned here, or the ranks that
``torchrun --nproc_per_node N`` started.  Every rank runs this CLI's work on
its own device (NCCL on ``cuda:{rank}``, gloo on the CPU with ``--device
cpu``), ``--batch_size`` is the global batch and must divide by N, and only
rank 0 preprocesses first, prints and writes the run's files.  Fewer
visible cards than N is refused before any work.

Refused by name before any work: plots without matplotlib.
"""

from __future__ import annotations

import argparse
import os


def parse_val_descriptor(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return value


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Sound event detection training "
                                                 "(PyTorch/CUDA port)")
    # Training data
    parser.add_argument("--dataset_dir", type=str, default="../data", help="Directory of dataset.")
    parser.add_argument("--dataset_name", type=str, default="FilmClap", help="FilmClap or TAU")
    parser.add_argument("--train_features", type=str, default="Waveform",
                        help="Waveform (M5 on raw frames; its checkpoints load into "
                             "cli.infer --arch M5) or Spectogram (--model)")
    parser.add_argument("--model", type=str, default="CnnAvgPooling",
                        choices=["CnnAvgPooling", "MobileNetV1"],
                        help="spectrogram model family; MobileNetV1 trains with its "
                             "head emitting logits, and its checkpoints load into "
                             "cli.infer --arch MobileNetV1")
    # Spectrogram-only arguments
    parser.add_argument("--preprocess_mode", type=str, default="logMel",
                        help="logMel or Complex; relevant only for Spectogram features")
    parser.add_argument("--force_preprocess", action="store_true", default=False)
    parser.add_argument("--preprocess_workers", type=int, default=0,
                        help="native reader threads for the WAV reads (0: one file "
                             "after another in this thread)")
    # Train
    parser.add_argument("--outputs_root", type=str, default="training_dir")
    parser.add_argument("--ckpt", type=str, default="")
    parser.add_argument("--resume", type=str, default="none", choices=["none", "auto"],
                        help="auto: restore the latest full checkpoint (weights, "
                             "optimizer state, schedule, step) of the run directory "
                             "and continue. --ckpt stays model-only like the "
                             "reference resume (main.py:37-39)")
    parser.add_argument("--val_descriptor", default=0.2,
                        help="float for percentage, string for fold substring")
    parser.add_argument("--train_tag", type=str, default="")
    # Training tricks
    parser.add_argument("--augment_data", action="store_true", default=False)
    parser.add_argument("--balance_classes", action="store_true", default=False)
    parser.add_argument("--recall_priority", type=float, default=5,
                        help="priority factor for the bce loss")
    parser.add_argument("--tau_labels", type=str, default="doorslam",
                        help="comma-separated TAU event classes")
    # Hyper parameters
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.000001)
    parser.add_argument("--num_train_steps", type=int, default=100000)
    parser.add_argument("--log_freq", type=int, default=5000)
    # Infrastructure
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on: cuda (default) or cpu")
    parser.add_argument("--num_devices", type=int, default=1,
                        help=">1 trains data-parallel over a ('data',) mesh of that "
                             "many devices, one rank each; batch_size is global")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="train steps per call: K > 1 runs K steps on a (K, batch) "
                             "block of start indices; num_train_steps and log_freq "
                             "must be multiples of K")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bfloat16 model compute (CnnAvgPooling and M5); parameters, "
                             "optimizer state and checkpoints stay float32")
    parser.add_argument("--debug_nans", action="store_true", default=False,
                        help="torch.autograd anomaly detection (NaN/inf in backward)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of steps 10-20 there "
                             "(a Chrome trace file)")
    parser.add_argument("--no_plot", action="store_true", default=False,
                        help="write no PNGs (they need matplotlib)")
    return parser


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Refuse, before any work, what cannot run: unknown training features,
    plots without matplotlib, and ``--num_devices`` beyond the visible
    devices (``sed_tpu``'s message) or not dividing ``--batch_size``."""
    from sed_tpu_torch.parallel.multihost import check_num_devices

    check_num_devices(args.num_devices, args.device)
    if args.num_devices > 1 and args.batch_size % args.num_devices:
        # sed_tpu's train() raises this after preprocessing; the port before
        # any work.
        raise ValueError(f"global batch_size={args.batch_size} must be divisible by "
                         f"the mesh size {args.num_devices}")
    if args.train_features.lower() not in ("spectogram", "waveform"):
        parser.error(f"training features can be raw waveform or spectogram only, "
                     f"'{args.train_features}' given")
    if not args.no_plot:
        from sed_tpu_torch.utils.plotting import require_matplotlib

        try:
            require_matplotlib()
        except RuntimeError as e:
            parser.error(str(e))


def compute_dtype(args):
    """The models' compute dtype: ``torch.bfloat16`` under ``--bf16``, else
    None (the input's, float32)."""
    import torch

    return torch.bfloat16 if args.bf16 else None


def get_spectrogram_dataset_and_model(args, mesh=None):
    """The dataset, model, config, run descriptor and mode of the
    spectrogram family.  Under ``mesh`` rank 0 preprocesses (and plots)
    first and the other ranks then read its cached features."""
    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.data.spectrogram_dataset import (SpectrogramDataset,
                                                        preprocess_film_clap_data,
                                                        preprocess_tau_sed_data)
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.parallel.mesh import barrier

    cfg = SpectrogramConfig(tau_sed_labels=tuple(args.tau_labels.split(",")))
    primary = mesh is None or mesh.rank == 0
    device = args.device if mesh is None else mesh.device

    def preprocess(force: bool):
        if args.dataset_name.lower() == "tau":
            return preprocess_tau_sed_data(
                args.dataset_dir, fold_name="eval", preprocess_mode=args.preprocess_mode,
                force_preprocess=force, cfg=cfg, workers=args.preprocess_workers,
                device=device, plot_sample=primary and not args.no_plot,
            )
        if args.dataset_name.lower() == "filmclap":
            return preprocess_film_clap_data(
                args.dataset_dir, preprocessed_mode=args.preprocess_mode,
                force_preprocess=force, cfg=cfg, workers=args.preprocess_workers,
                device=device, plot_sample=primary and not args.no_plot,
            )
        raise ValueError(
            f"Only tau and filmclap datasets are supported, '{args.dataset_name}' given"
        )

    if primary:
        features_dir, mean_std_file = preprocess(args.force_preprocess)
    barrier(mesh)
    if not primary:
        features_dir, mean_std_file = preprocess(False)

    dataset = SpectrogramDataset(
        features_dir, mean_std_file,
        augment_data=args.augment_data,
        balance_classes=args.balance_classes,
        val_descriptor=parse_val_descriptor(args.val_descriptor),
        preprocessed_mode=args.preprocess_mode,
        cfg=cfg,
        seed=args.seed,
    )
    if args.model == "MobileNetV1":
        model = MobileNetV1(classes_num=cfg.classes_num, emit="logits")
        descriptor = f"MobileNetV1-{args.preprocess_mode}-{cfg.cfg_descriptor}"
    else:
        # Model config from the reference training CLI (main.py:35).
        model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL, dtype=compute_dtype(args))
        descriptor = f"{args.preprocess_mode}-{cfg.cfg_descriptor}"
    return dataset, model, cfg, descriptor, "spectogram"


def get_waveform_dataset_and_model(args):
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.io.tau import ensure_tau_data, get_tau_sed_paths_and_labels
    from sed_tpu_torch.models.m5 import M5

    cfg = WaveformConfig(tau_sed_labels=tuple(args.tau_labels.split(",")))
    if args.dataset_name.lower() == "tau":
        audio_dir, meta_data_dir = ensure_tau_data(
            f"{args.dataset_dir}/Tau_sound_events_2019", fold_name="eval"
        )
        items = get_tau_sed_paths_and_labels(audio_dir, meta_data_dir, cfg)
    elif args.dataset_name.lower() == "filmclap":
        items = get_film_clap_paths_and_labels(
            os.path.join(args.dataset_dir, "FilmClap"), cfg.time_margin
        )
    else:
        raise ValueError(
            f"Only tau and filmclap datasets are supported, '{args.dataset_name}' given"
        )

    dataset = WaveformDataset(
        items,
        augment_data=args.augment_data,
        balance_classes=args.balance_classes,
        val_descriptor=parse_val_descriptor(args.val_descriptor),
        cfg=cfg,
        seed=args.seed,
        workers=args.preprocess_workers,
    )
    # The reference hardcodes M5(1) (main.py:69) because classes_num is pinned
    # to 1; with a real multi-class label list the head must match.
    model = M5(cfg.classes_num, dtype=compute_dtype(args))
    return dataset, model, cfg, cfg.cfg_descriptor, "waveform"


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)

    from sed_tpu_torch.inference import resolve_device

    resolve_device(args.device)
    if args.train_features.lower() == "spectogram" and args.model == "MobileNetV1" \
            and args.bf16:
        # sed_tpu raises this after preprocessing; the port before any work.
        raise ValueError("--bf16 is implemented for CnnAvgPooling only")
    from sed_tpu_torch.parallel.multihost import run_on_devices

    run_on_devices(run, args.num_devices, args.device, (args,))


def run(args, mesh=None) -> None:
    """Preprocess, build the dataset and the model, restore a checkpoint and
    train, on ``args.device`` or, under ``mesh``, on this rank's device."""
    import torch

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    if args.train_features.lower() == "spectogram":
        dataset, model, cfg, descriptor, mode = get_spectrogram_dataset_and_model(args, mesh)
    else:
        if args.model != "CnnAvgPooling":
            raise ValueError("--model selects the spectrogram family; "
                             "waveform training uses M5")
        dataset, model, cfg, descriptor, mode = get_waveform_dataset_and_model(args)

    train_name = f"{args.dataset_name}_cfg({descriptor}_b{args.batch_size}_lr{args.lr}_{args.train_tag}"
    if args.balance_classes:
        train_name += "_BC"
    if args.augment_data:
        train_name += "_AD"
    outputs_dir = os.path.join(args.outputs_root, train_name)

    from sed_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from sed_tpu_torch.train.loop import train
    from sed_tpu_torch.train.state import init_state

    initial_state = None
    resume_path = None
    model_only = True
    if args.resume == "auto":
        resume_path = latest_checkpoint(outputs_dir)
        model_only = False
        if resume_path:
            print(f"Auto-resuming from {resume_path}")
    if resume_path is None and args.ckpt:
        resume_path = args.ckpt
        model_only = True
    device = args.device if mesh is None else mesh.device
    if resume_path:
        template = init_state(model, args.lr, device, args.seed)
        initial_state = load_checkpoint(resume_path, template, model_only=model_only)

    train(
        model, dataset, mode,
        num_steps=args.num_train_steps,
        lr=args.lr,
        log_freq=args.log_freq,
        outputs_dir=outputs_dir,
        batch_size=args.batch_size,
        pos_weight=args.recall_priority,
        augment=args.augment_data,
        preprocessed_mode=args.preprocess_mode,
        cfg=cfg,
        seed=args.seed,
        initial_state=initial_state,
        make_plots=not args.no_plot,
        profile_dir=args.profile_dir or None,
        mesh=mesh,
        steps_per_call=args.steps_per_call,
        device=args.device,
    )


if __name__ == "__main__":
    main()

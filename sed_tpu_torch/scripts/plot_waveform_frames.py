"""Debug script: the event-positive waveform training crops (counterpart of
the root ``plot_waveform_frames.py``; reference: the ``__main__`` block of
dataset/waveform/waveform_dataset.py:160-189).

    python -m sed_tpu_torch.scripts.plot_waveform_frames --dataset_dir D
        [--dataset_name FilmClap|tau] [--out_dir debug] [--num_frames 20]
        [--seed 0] [--device cuda|cpu] [--no_plot]

Walks the port's ``WaveformDataset`` (``val_descriptor=0``) and keeps the
first ``--num_frames`` positive crops: a PNG each, as the root script
draws them, or with ``--no_plot`` one ``positive_frames.npz`` in
``--out_dir`` (``frames``: (n, channels, frame_size); ``indices``: their
dataset indices).  The crops are cut on the host; ``--device`` is checked
(a missing card is refused) as in the other entries.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sed_tpu_torch.utils.plotting import refuse_plot_without_matplotlib

NPZ_NAME = "positive_frames.npz"


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Plot positive waveform crops (PyTorch/CUDA port)")
    parser.add_argument("--dataset_dir", type=str, default="../data")
    parser.add_argument("--dataset_name", type=str, default="FilmClap")
    parser.add_argument("--out_dir", type=str, default="debug")
    parser.add_argument("--num_frames", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the run: cuda (default) or cpu")
    parser.add_argument("--no_plot", action="store_true", default=False,
                        help=f"write the crops to {NPZ_NAME} instead of PNGs")
    return parser


def dataset_items(dataset_dir, dataset_name, cfg):
    if dataset_name.lower() == "filmclap":
        from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels

        return get_film_clap_paths_and_labels(os.path.join(dataset_dir, "FilmClap"),
                                              cfg.time_margin)
    from sed_tpu_torch.io.tau import ensure_tau_data, get_tau_sed_paths_and_labels

    audio_dir, meta_dir = ensure_tau_data(
        os.path.join(dataset_dir, "Tau_sound_events_2019"), fold_name="eval"
    )
    return get_tau_sed_paths_and_labels(audio_dir, meta_dir, cfg)


def positive_frames(dataset, num_frames):
    """(indices, frames) of the first ``num_frames`` positive crops."""
    indices, frames = [], []
    for i in range(len(dataset)):
        frame, label = dataset.get_item(i)
        if not label:
            continue
        indices.append(i)
        frames.append(np.asarray(frame))
        if len(frames) >= num_frames:
            break
    return indices, frames


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_plot_without_matplotlib(parser, args.no_plot)

    from sed_tpu_torch.configs import DEFAULT_WAVEFORM as cfg
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.inference import resolve_device

    resolve_device(args.device)
    items = dataset_items(args.dataset_dir, args.dataset_name, cfg)
    dataset = WaveformDataset(items, val_descriptor=0.0, cfg=cfg, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    indices, frames = positive_frames(dataset, args.num_frames)
    if args.no_plot:
        stacked = (np.stack(frames) if frames
                   else np.zeros((0, cfg.audio_channels, cfg.frame_size), np.float32))
        np.savez(os.path.join(args.out_dir, NPZ_NAME), frames=stacked,
                 indices=np.asarray(indices, np.int64))
    else:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        for i, frame in zip(indices, frames):
            plt.plot(range(frame.shape[1]), frame[0], c="r")
            plt.ylim(-0.5, 0.5)
            plt.autoscale(tight=True)
            plt.savefig(os.path.join(args.out_dir, f"a_{i}.png"))
            plt.clf()
    print(f"wrote {len(frames)} positive frames to {args.out_dir}/")
    return indices, frames


if __name__ == "__main__":
    main()

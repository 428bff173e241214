"""Exploration script: the log-mel spectrogram and waveform of an audio
segment (counterpart of the root ``analyze_spectogram.py``).

    python -m sed_tpu_torch.scripts.analyze_spectogram a.wav [--sec_start S]
        [--sec_end E] [--out spectogram_analysis.png] [--save_segment seg.wav]
        [--device cuda|cpu] [--no_plot]

The features are the port's ``logmel_features`` on ``--device`` (on CUDA:
K1, the STFT power, then K2, the mel-log).  The plot is the root script's;
with ``--no_plot`` the feature array (channels, frames, mel) and the
segment's waveform (samples, channels) go to an ``.npz`` beside ``--out``
(its extension replaced) instead.  Either way it prints ``wrote <file>;
feature shape <shape>``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sed_tpu_torch.utils.plotting import refuse_plot_without_matplotlib


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Plot a spectrogram segment (PyTorch/CUDA port)")
    parser.add_argument("audio_path", type=str)
    parser.add_argument("--sec_start", type=float, default=0.0)
    parser.add_argument("--sec_end", type=float, default=None)
    parser.add_argument("--out", type=str, default="spectogram_analysis.png")
    parser.add_argument("--save_segment", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the featurizer: cuda (default) or cpu")
    parser.add_argument("--no_plot", action="store_true", default=False,
                        help="write the arrays to an .npz beside --out instead of a PNG")
    return parser


def segment_features(audio_path, sec_start=0.0, sec_end=None, device="cuda", save_segment=""):
    """(feature, waveform): the log-mel features (channels, frames, mel)
    and the float64 waveform (samples, channels) of the segment."""
    import torch

    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM as cfg
    from sed_tpu_torch.inference import resolve_device
    from sed_tpu_torch.io.audio import read_multichannel_audio, write_wav
    from sed_tpu_torch.ops.featurizer import logmel_features

    device = resolve_device(device)
    waveform = read_multichannel_audio(audio_path, target_fs=cfg.working_sample_rate, cfg=cfg)
    start = int(cfg.working_sample_rate * sec_start)
    end = int(cfg.working_sample_rate * sec_end) if sec_end else len(waveform)
    waveform = waveform[start:end]
    if save_segment:
        write_wav(save_segment, waveform[:, 0], cfg.working_sample_rate)
    x = torch.from_numpy(np.ascontiguousarray(waveform.astype(np.float32))).to(device)
    return logmel_features(x, cfg).cpu().numpy(), waveform


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_plot_without_matplotlib(parser, args.no_plot)
    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM as cfg

    feature, waveform = segment_features(args.audio_path, args.sec_start, args.sec_end,
                                         args.device, args.save_segment)
    if args.no_plot:
        out = os.path.splitext(args.out)[0] + ".npz"
        np.savez(out, feature=feature, waveform=waveform)
        print(f"wrote {out}; feature shape {feature.shape}")
        return feature

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    frames_num = feature.shape[1]
    tick_hop = max(1, frames_num // 20)
    xticks = np.concatenate((np.arange(0, frames_num - tick_hop, tick_hop), [frames_num]))
    xlabels = [f"{x / cfg.frames_per_second:.3f}s" for x in xticks]

    fig = plt.figure()
    ax = fig.add_subplot(211)
    ax.matshow(feature[0].T, origin="lower", cmap="jet")
    ax.set_xticks(xticks)
    ax.set_xticklabels(xlabels, rotation="vertical")
    ax.xaxis.set_ticks_position("bottom")

    ax = fig.add_subplot(212)
    signal = waveform.mean(1)
    ax.plot(range(len(signal)), signal)
    ax.get_xaxis().set_visible(False)
    ax.get_yaxis().set_visible(False)
    plt.autoscale(tight=True)
    plt.savefig(args.out)
    plt.close(fig)
    print(f"wrote {args.out}; feature shape {feature.shape}")
    return feature


if __name__ == "__main__":
    main()

"""Diagnostic images: spectrogram or waveform panels with predicted and
reference event rows (counterpart of ``sed_tpu.utils.plotting``).

matplotlib (Agg backend) is imported inside the functions that draw, never
when the module is imported: the port runs where matplotlib is absent, and
a run that draws nothing never needs it.  :func:`require_matplotlib` lets a
caller refuse a plot before any work starts.
"""

from __future__ import annotations

import os

import numpy as np

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM


def require_matplotlib() -> None:
    """Raise ``RuntimeError`` naming ``--no_plot`` when matplotlib is absent."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError("the plot needs matplotlib, which is not installed; "
                           "pass --no_plot to score without it") from e


def refuse_plot_without_matplotlib(parser, no_plot: bool) -> None:
    """``parser.error`` (exit 2, before any work) when a plot is asked
    for and matplotlib is absent."""
    if not no_plot:
        try:
            require_matplotlib()
        except RuntimeError as e:
            parser.error(str(e))


def plot_waveform(ax, waveform, sample_rate):
    """10x subsampled amplitude plot."""
    ax.set_facecolor("k")
    new_sample_rate = sample_rate / 10
    new_waveform = np.asarray(waveform)[::10]
    ax.plot(range(len(new_waveform)), new_waveform, c="r")
    ax.margins(x=0)
    ax.set_title("Time", color="r")
    ax.set_ylabel("Amplitudes")
    xticks = np.arange(0, len(new_waveform), max(len(new_waveform) // 8, 1))
    ax.set_xticks(xticks)
    ax.set_xticklabels([f"{x / new_sample_rate:.2f}s" for x in xticks])
    ax.xaxis.set_ticks_position("bottom")


def plot_spectrogram(ax, spectrogram, frames_per_second):
    """(frames, mel_bins) log-mel as an image."""
    spectrogram = np.asarray(spectrogram)
    frames_num, mel_bins = spectrogram.shape
    colorbar = ax.matshow(spectrogram.T, origin="lower", aspect="auto", cmap="jet")
    ax.set_title("Log mel spectrogram", color="r")
    ax.set_ylabel("Mel bins")
    ax.set_yticks([0, mel_bins])
    ax.set_yticklabels([0, mel_bins])
    tick_hop = max(frames_num // 8, 1)
    xticks = np.concatenate((np.arange(0, frames_num - tick_hop, tick_hop), [frames_num]))
    ax.set_xticks(xticks)
    ax.set_xticklabels([f"frame {x}\n{x / frames_per_second:.1f}s" for x in xticks])
    ax.xaxis.set_ticks_position("bottom")
    return colorbar


def plot_classification_matrix(ax, mat, frames_per_second):
    """(frames, classes) scores or labels in [0, 1] as an image."""
    mat = np.asarray(mat)
    frames_num = mat.shape[0]
    colorbar = ax.matshow(mat.T, origin="lower", aspect="auto", cmap="jet", vmin=0, vmax=1)
    tick_hop = max(frames_num // 8, 1)
    xticks = np.concatenate((np.arange(0, frames_num - tick_hop, tick_hop), [frames_num]))
    ax.set_xticks(xticks)
    ax.set_xticklabels([f"frame {x}\n{x / frames_per_second:.1f}s" for x in xticks])
    ax.xaxis.set_ticks_position("bottom")
    return colorbar


def _add_colorbar(fig, ax, colorbar):
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    cax = make_axes_locatable(ax).append_axes("right", size="1%", pad=0.01)
    fig.colorbar(colorbar, cax=cax, orientation="vertical")


def plot_sample_features(input, mode, output=None, target=None, file_name=None,
                         plot_path=None, cfg=DEFAULT_SPECTROGRAM):
    """Composite sample image: features + predicted + reference event rows.

    ``input``: (channels, frames, mel_bins) log-mel (``mode='spectogram'``)
    or (channels, frames, samples) waveform frames; ``output``/``target``:
    (frames, classes).  Written to ``plot_path``.
    """
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    os.makedirs(os.path.dirname(plot_path), exist_ok=True)
    num_plots = 1 + (output is not None) + (target is not None)

    fig, axs = plt.subplots(num_plots, 1, figsize=(20, 20), squeeze=False)
    axs = axs[:, 0]
    plt.subplots_adjust(hspace=1)
    if file_name:
        fig.suptitle(f"Sample name: {file_name}")

    input = np.asarray(input).mean(0)  # mean over channels
    frames_per_second = cfg.frames_per_second
    if mode.lower() == "spectogram":
        colorbar = plot_spectrogram(axs[0], input, frames_per_second)
        _add_colorbar(fig, axs[0], colorbar)
    else:  # waveform
        waveform = input[:, : cfg.hop_size].flatten()
        plot_waveform(axs[0], waveform, cfg.working_sample_rate)
        make_axes_locatable(axs[0]).append_axes("right", size="1%", pad=0.01)

    if output is not None:
        colorbar = plot_classification_matrix(axs[1], output, frames_per_second)
        axs[1].set_title("Predicted sound events", color="b")
        _add_colorbar(fig, axs[1], colorbar)

    if target is not None:
        idx = 1 if output is None else 2
        colorbar = plot_classification_matrix(axs[idx], target, frames_per_second)
        axs[idx].set_title(
            f"Reference sound events, marked frames: {int(np.asarray(target).sum())}", color="r"
        )
        _add_colorbar(fig, axs[idx], colorbar)

    fig.tight_layout()
    plt.savefig(plot_path)
    plt.close("all")

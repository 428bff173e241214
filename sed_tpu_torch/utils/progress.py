"""Training progress tracking: loss/metric curves, P-R plots, JSONL metrics
(counterpart of ``sed_tpu.utils.progress``).

Reference: ProgressPlotter (utils/common.py:33-99) — emits Training_loss.png,
Metrics.png and ROC_plots/Roc-iteration-N.png.  This version writes the same
artifacts plus a machine-readable ``metrics.jsonl`` (one record per log point).

matplotlib (Agg backend) is imported only inside the plot methods, so
:meth:`ProgressPlotter.record` (metrics.jsonl) works where matplotlib is
absent.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sed_tpu_torch.utils.metrics import f_score


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


class ProgressPlotter:
    def __init__(self):
        self.train_buffer = []
        self.train_avgs = []
        self.val_avgs = []
        self.f1_score_avgs = []
        self.f5_score_avgs = []
        self.AP_avgs = []
        self.iterations = []
        self.last_recal_vals = None
        self.last_precision_vals = None
        self.last_event_metrics = None
        self.last_segment_metrics = None
        self.last_per_class = None

    def report_train_loss(self, loss: float):
        self.train_buffer.append(float(loss))

    def report_event_metrics(self, metrics: dict):
        """Micro-averaged event-based P/R/F1 for this log point
        (utils/event_metrics.py micro_average) — rides metrics.jsonl as
        event_* fields; no PNG (the reference artifacts stay unchanged)."""
        self.last_event_metrics = dict(metrics)

    def report_segment_metrics(self, metrics: dict):
        """Micro-averaged segment-based P/R/F1 + error rate for this log
        point (utils/event_metrics.py micro_average_segments) — rides
        metrics.jsonl as segment_* fields."""
        self.last_segment_metrics = dict(metrics)

    def report_per_class_metrics(self, frame_ap_per_class, event_macro,
                                 segment_macro):
        """Class-wise view for this log point (sed_eval macro convention;
        utils/event_metrics.py macro_average_classes): per-class frame AP
        (recording-averaged) + macro event/segment P/R/F1 — rides
        metrics.jsonl as AP_per_class / macro_AP / event_macro_* /
        segment_macro_* fields."""
        self.last_per_class = {
            "AP_per_class": [float(a) for a in frame_ap_per_class],
            "macro_AP": float(np.mean(frame_ap_per_class)),
            **{f"event_macro_{k}": float(event_macro[k])
               for k in ("precision", "recall", "f1")},
            **{f"segment_macro_{k}": float(segment_macro[k])
               for k in ("precision", "recall", "f1")},
        }

    def report_validation_metrics(self, val_losses, recal_sets, precision_sets, APs, iteration):
        self.iterations.append(int(iteration))
        self.val_avgs.append(float(np.mean(val_losses)))
        self.AP_avgs.append(float(np.mean(APs)))
        self.last_recal_vals = np.mean(recal_sets, axis=0)
        self.last_precision_vals = np.mean(precision_sets, axis=0)
        # NOTE: argument order follows the reference call site
        # (utils/common.py:52-53 passes precision first into f_score(recll, precision)).
        f1 = f_score(self.last_precision_vals, self.last_recal_vals, precision_importance_factor=1)
        f5 = f_score(self.last_precision_vals, self.last_recal_vals, precision_importance_factor=5)
        self.f1_score_avgs.append(float(np.max(f1)))
        self.f5_score_avgs.append(float(np.max(f5)))

    def record(self, outputs_dir: str):
        """Flush the train-loss buffer and append the machine-readable record.

        Separate from :meth:`plot` so headless runs (make_plots=False) still
        produce metrics.jsonl.
        """
        os.makedirs(outputs_dir, exist_ok=True)
        self.train_avgs.append(
            float(np.mean(self.train_buffer)) if self.train_buffer else float("nan")
        )
        self.train_buffer = []
        self._append_jsonl(os.path.join(outputs_dir, "metrics.jsonl"))

    def plot(self, outputs_dir: str):
        """Render the PNG artifacts (call :meth:`record` first each log point)."""
        os.makedirs(outputs_dir, exist_ok=True)
        self._plot_train_eval_losses(os.path.join(outputs_dir, "Training_loss.png"))
        self._plot_metrics(os.path.join(outputs_dir, "Metrics.png"))
        self._plot_pr(os.path.join(outputs_dir, "ROC_plots",
                                   f"Roc-iteration-{self.iterations[-1]}.png"))

    def _append_jsonl(self, path: str):
        record = {
            "iteration": self.iterations[-1],
            "train_loss": self.train_avgs[-1],
            "val_loss": self.val_avgs[-1],
            "AP": self.AP_avgs[-1],
            "max_f1": self.f1_score_avgs[-1],
            "max_f5": self.f5_score_avgs[-1],
        }
        if self.last_event_metrics is not None:
            record.update({f"event_{k}": v
                           for k, v in self.last_event_metrics.items()
                           if not isinstance(v, dict)})
            self.last_event_metrics = None
        if self.last_segment_metrics is not None:
            record.update({f"segment_{k}": v
                           for k, v in self.last_segment_metrics.items()})
            self.last_segment_metrics = None
        if self.last_per_class is not None:
            record.update(self.last_per_class)
            self.last_per_class = None
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _plot_train_eval_losses(self, plot_path: str):
        plt = _pyplot()
        plt.plot(np.arange(len(self.train_avgs)), self.train_avgs, label="train", color="blue")
        plt.plot(np.arange(len(self.val_avgs)), self.val_avgs, label="validation", color="orange")
        x_indices = np.arange(0, len(self.iterations), max(len(self.iterations) // 5, 1))
        plt.xticks(x_indices, np.array(self.iterations)[x_indices])
        plt.xlabel("train step")
        plt.ylabel("loss")
        plt.legend()
        plt.savefig(plot_path)
        plt.clf()

    def _plot_metrics(self, plot_path: str):
        plt = _pyplot()
        plt.plot(np.arange(len(self.f1_score_avgs)), self.f1_score_avgs, color="blue", label="Max f1 score")
        plt.plot(np.arange(len(self.f5_score_avgs)), self.f5_score_avgs, color="green", label="Max f5 score")
        plt.plot(np.arange(len(self.AP_avgs)), self.AP_avgs, color="orange", label="Average precision")
        plt.title("Metrics")
        x_indices = np.arange(0, len(self.iterations), max(len(self.iterations) // 5, 1))
        plt.xticks(x_indices, np.array(self.iterations)[x_indices])
        plt.legend()
        plt.savefig(plot_path)
        plt.clf()

    def _plot_pr(self, plot_path: str):
        plt = _pyplot()
        os.makedirs(os.path.dirname(plot_path), exist_ok=True)
        plt.plot(self.last_recal_vals, self.last_precision_vals)
        plt.xticks([0, 0.25, 0.5, 0.75, 1])
        plt.yticks([0, 0.25, 0.5, 0.75, 1])
        mean_ap = np.sum(
            self.last_precision_vals[:-1]
            * (self.last_recal_vals[:-1] - self.last_recal_vals[1:])
        )
        plt.title(f"Validation AVG ROC\nAP: {mean_ap:.2f}")
        plt.xlabel("Avg Recall")
        plt.ylabel("Avg Precision")
        plt.savefig(plot_path)
        plt.clf()

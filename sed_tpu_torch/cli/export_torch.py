"""Checkpoint migration CLI: a port or ``sed_tpu`` checkpoint -> reference
torch ``.pth`` (counterpart of ``sed_tpu.cli.export_torch``).

    python -m sed_tpu_torch.cli.export_torch --ckpt runs/.../iteration_60000.pt \\
        --arch CnnAvgPooling --out iteration_60000.pth [--device cuda|cpu]

``--ckpt`` is a port ``iteration_{n}.pt``, a ``sed_tpu`` msgpack ``.ckpt``
or its orbax ``.ckpt.orbax`` directory (the files ``python -m
sed_tpu.cli.export_torch`` takes).  The weights load once, ``strict=True``,
into the model on ``--device`` before the file is written.  Prints one JSON line.  The format:
sed_tpu_torch/train/torch_export.py.
"""

from __future__ import annotations

import argparse
import json


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a checkpoint to the reference .pth format (PyTorch/CUDA port)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="a port iteration_{n}.pt or a sed_tpu .ckpt (msgpack) / .ckpt.orbax")
    p.add_argument("--out", type=str, required=True,
                   help="output .pth path (reference container: "
                        "{'iterations', 'model', 'optimizer'})")
    p.add_argument("--arch", type=str, default="CnnAvgPooling",
                   choices=["CnnAvgPooling", "MobileNetV1", "M5"])
    p.add_argument("--tau_labels", type=str, default="doorslam",
                   help="comma-separated event classes — must match the "
                        "training run's class list")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the weights are loaded on: cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from sed_tpu_torch.cli.infer import build_model
    from sed_tpu_torch.train.torch_export import export_torch_checkpoint

    labels = tuple(args.tau_labels.split(","))
    model = build_model(args.arch, len(labels))
    path = export_torch_checkpoint(args.ckpt, model, args.out, device=args.device)
    print(json.dumps({"pth": path, "arch": args.arch, "classes": len(labels)}))
    return path


if __name__ == "__main__":
    main()

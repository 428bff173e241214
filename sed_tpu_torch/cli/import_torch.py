"""Checkpoint migration CLI: reference torch ``.pth`` -> the port's
checkpoint (counterpart of ``sed_tpu.cli.import_torch``).

    python -m sed_tpu_torch.cli.import_torch --pth runs/.../iteration_60000.pth \\
        --out imported_run --arch CnnAvgPooling [--device cuda|cpu]

writes ``imported_run/checkpoints/iteration_60000.pt`` (the port's full-state
format with a fresh optimizer), which ``--ckpt`` of the port's infer, stream
and socket CLIs and ``--resume`` of its training CLI read.  The weights load
once, ``strict=True``, into the model on ``--device`` before the file is
written.  Prints one JSON line.  The key check: sed_tpu_torch/train/torch_import.py.
"""

from __future__ import annotations

import argparse
import json


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference torch checkpoint (PyTorch/CUDA port)")
    p.add_argument("--pth", type=str, required=True,
                   help="reference checkpoint (.pth), read with weights_only=True")
    p.add_argument("--out", type=str, required=True,
                   help="output run directory (checkpoint written under "
                        "<out>/checkpoints/)")
    p.add_argument("--arch", type=str, default="CnnAvgPooling",
                   choices=["CnnAvgPooling", "MobileNetV1", "M5"])
    p.add_argument("--tau_labels", type=str, default="doorslam",
                   help="comma-separated event classes — must match the "
                        "torch training run's class list")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the weights are loaded on: cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from sed_tpu_torch.cli.infer import build_model
    from sed_tpu_torch.train.torch_import import import_torch_checkpoint

    labels = tuple(args.tau_labels.split(","))
    model = build_model(args.arch, len(labels))
    path = import_torch_checkpoint(args.pth, model, args.out, device=args.device)
    print(json.dumps({"ckpt": path, "arch": args.arch, "classes": len(labels)}))
    return path


if __name__ == "__main__":
    main()

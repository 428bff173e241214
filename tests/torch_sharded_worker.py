"""Each rank of tests/test_torch_sharded_export.py's two-rank gloo group:
it exports every sharded artifact with its mesh (rank 0 writes them, as
``cli/serve.py build`` does), loads each with its mesh, scores the same
global batch and saves what it got beside the inputs.  This module imports
torch and the port only, so the ranks start without JAX.
"""

from __future__ import annotations

import os

import torch

from sed_tpu_torch import export as ex
from sed_tpu_torch.parallel.mesh import barrier, create_mesh


def export(kind: str, head, audio, cfg, mesh) -> bytes:
    """The artifact of ``head`` for a batch shaped like ``audio`` on the
    CPU, sharded over ``mesh`` (none: one device): ``kind`` 'pipeline'
    (spectrogram), 'm5' or 'fn' (the head alone)."""
    if kind == "fn":
        return ex.aot_export_fn(head, torch.zeros(audio.shape), mesh=mesh)
    export_fn = ex.aot_export_m5_pipeline if kind == "m5" else ex.aot_export_pipeline
    return export_fn(head, audio.shape[0], audio.shape[1], cfg, mesh=mesh, device="cpu")


def rank_main(root: str) -> None:
    """``inputs.pt``: ``{"heads": {tag: (kind, head, cfg)}, "audio": {tag:
    global batch}, "cli": [(build argv, run argv)]}`` -> ``{tag}.aot``
    (rank 0) and ``rank{r}.pt``: each artifact's scores through
    ``load_aot_pipeline(mesh=)`` (``load_scorer`` for kind 'fn'), through
    ``load_aot_fn(mesh=)``, and the loaded program's device and header
    fields.  Then what ``cli/serve.py`` runs on each rank: ``build`` and
    ``run`` of every argv pair (rank 0 writes their files)."""
    from sed_tpu_torch.cli import serve

    torch.set_num_threads(1)
    mesh = create_mesh(2, devices=["cpu", "cpu"])
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    for tag, (kind, head, cfg) in inputs["heads"].items():
        blob = export(kind, head, inputs["audio"][tag], cfg, mesh)
        if mesh.rank == 0:
            with open(os.path.join(root, f"{tag}.aot"), "wb") as f:
                f.write(blob)
    barrier(mesh)
    out = {}
    for tag, (kind, _, _) in inputs["heads"].items():
        with open(os.path.join(root, f"{tag}.aot"), "rb") as f:
            blob = f.read()
        audio = inputs["audio"][tag]
        loader = ex.load_scorer if kind == "fn" else ex.load_aot_pipeline
        call = loader(blob, device="cpu", mesh=mesh)
        raw = ex.load_aot_fn(blob, mesh=mesh)
        out[tag] = {"scores": call(audio),
                    "raw": raw(torch.as_tensor(audio)).numpy(),
                    "n_devices": call.n_devices, "shard_shape": call.shard_shape,
                    "input_shape": call.input_shape, "device": str(call.device)}
    torch.save(out, os.path.join(root, f"rank{mesh.rank}.pt"))
    parser = serve.build_arg_parser()
    for build_argv, run_argv in inputs["cli"]:
        serve.build(parser.parse_args(build_argv), mesh)
        barrier(mesh)
        serve.run(parser.parse_args(run_argv), mesh)

"""Serving artifacts: exported scorers and AOT serving pipelines
(counterpart of ``sed_tpu.export``).

``sed_tpu`` ships two tiers, and so does the port:

  * **scorers** (:func:`export_scorer`, :func:`export_quantized_scorer`,
    :func:`load_scorer`): the model head alone, log-mel features -> sigmoid
    scores, with the weights inside;
  * **AOT pipelines** (:func:`aot_export_pipeline`,
    :func:`aot_export_m5_pipeline`, :func:`load_aot_pipeline`): the whole
    serving graph, (batch, samples, 1) int16 PCM (or uint8 µ-law, or float)
    -> featurizer -> float32, bfloat16 or int8 model -> sigmoid scores,
    which a fresh process runs without the model's Python classes and
    without compiling anything.

``sed_tpu``'s artifact is a compiled XLA executable in a pickle.  The port's
eager PyTorch compiles no graph; its one compile step is ``nvcc`` on the
featurizer kernels (``ops/cuda_featurizer.build``).  So a port artifact,
format ``sed_tpu_torch-aot-v1``, is a zip of:

  * ``program.pt2``: the ``torch.export`` program.  K1 and K2 are in its
    graph as the custom operators ``sed_tpu_torch::wave_stft_power`` and
    ``sed_tpu_torch::mel_log`` (CUDA kernels on the card, their plain
    versions on the CPU); the int8 products are ``torch._int_mm`` on CUDA
    and an exact float64 product on the CPU (``ops/int8.py``);
  * ``header.json``: format and version, input shape and dtype, the number
    of devices and each one's shard shape, device type and name, torch and
    CUDA versions, the caller's ``meta``, the custom operators in the graph,
    and the kernel library's digest and sha256;
  * for a CUDA program that holds K1 or K2, ``libsed_featurizer_{digest}.so``,
    the library ``build()`` made from this repository's ``featurizer.cu``.
    The loader installs it into ``_build/`` when it is missing there, so
    the kernels load without ``nvcc``.

The port's heads and pipelines take port models with their weights inside
(in place of ``sed_tpu``'s ``(model, params, batch_stats)``) and return
``nn.Module``s; ``aot_export_*`` and :func:`aot_export_fn` export any module.
A program runs only on the device type it was traced on: the featurizer
and the int8 products pick their CUDA or CPU kernels while tracing.  The
loaders place it on the device they are given (``torch.export``'s
``move_to_device_pass``): its weights, its constants and the devices its
graph names, which are the tracing device's otherwise.

**Sharded artifacts** (``mesh=``, a ``parallel.mesh.Mesh``).  ``sed_tpu``
compiles one program over N devices with the batch sharded and the weights
replicated.  The port runs one rank per device, so its sharded artifact
holds one program traced on one rank's rows, (B / N, samples, 1); the
header keeps the global ``input_shape`` and adds ``n_devices`` and
``shard_shape`` (an artifact without ``n_devices`` is a 1-device one, as
``sed_tpu`` reads it).  Each rank loads it with ``mesh=`` onto its own
device, runs it on its rows (``mesh.local_rows``) and gathers the scores
outside the program (``mesh.gather_rows``), as
``parallel.data_parallel.shard_inference`` does.

.. warning:: loading a CUDA artifact installs and runs the native library
   it carries.  Load TRUSTED artifacts only (ones you built).
"""

from __future__ import annotations

import hashlib
import io
import json
import time
import zipfile

import numpy as np
import torch
from torch import nn

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.inference import emits_scores, resolve_device
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.featurizer import (ingest_to_f32, logmel_features_batch,
                                          resolve_featurizer_precision)
from sed_tpu_torch.parallel.mesh import gather_rows, local_rows
from sed_tpu_torch.utils.precision import full_float32

FORMAT = "sed_tpu_torch-aot-v1"
VERSION = 1
_PROGRAM, _HEADER = "program.pt2", "header.json"


# ---------------------------------------------------------------------------
# The heads
# ---------------------------------------------------------------------------

class _Normalize(nn.Module):
    """``(feats - mean) / std`` over the mel axis, the statistics as
    buffers (``sed_tpu``'s ``_norm_weights``/``_apply_norm``); no
    statistics, no change."""

    def __init__(self, mean=None, std=None):
        super().__init__()
        self.on = mean is not None
        if self.on:
            self.register_buffer("mean", torch.as_tensor(np.asarray(mean, np.float32)))
            self.register_buffer("std", torch.as_tensor(np.asarray(std, np.float32)))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return (feats - self.mean) / self.std if self.on else feats


class _Leaf:
    """Where :class:`_Tree` keeps a tensor: the name of its buffer."""

    def __init__(self, name: str):
        self.name = name


class _Tree(nn.Module):
    """A nested dict/list of tensors and statics (an int8 artifact) with
    every tensor registered as a buffer, so an exported program carries
    them as its weights; :meth:`tree` rebuilds the structure."""

    def __init__(self, tree):
        super().__init__()
        self.template = self._register(tree, "q")

    def _register(self, node, path):
        if torch.is_tensor(node):
            # Contiguous copies: an exported program saves its weights whole.
            self.register_buffer(path, node.detach().clone(memory_format=torch.contiguous_format))
            return _Leaf(path)
        if isinstance(node, dict):
            return {k: self._register(v, f"{path}_{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [self._register(v, f"{path}_{i}") for i, v in enumerate(node)]
        return node

    def tree(self):
        return self._rebuild(self.template)

    def _rebuild(self, node):
        if isinstance(node, _Leaf):
            return getattr(self, node.name)
        if isinstance(node, dict):
            return {k: self._rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self._rebuild(v) for v in node]
        return node


class CnnServing(nn.Module):
    """The float head of a spectrogram CNN: feats (B, C, T, mel) ->
    normalize -> model -> sigmoid (none for a model that emits scores)."""

    def __init__(self, model: nn.Module, mean=None, std=None):
        super().__init__()
        self.norm = _Normalize(mean, std)
        self.model = model
        self.sigmoid = not emits_scores(model)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        out = self.model(self.norm(feats))
        return torch.sigmoid(out) if self.sigmoid else out


class QuantizedServing(nn.Module):
    """An int8 head: (normalize ->) ``forward(qparams, x)`` (-> sigmoid),
    the artifact's tensors as buffers."""

    def __init__(self, forward, qparams, mean=None, std=None, sigmoid: bool = True):
        super().__init__()
        self.norm = _Normalize(mean, std)
        self.q = _Tree(qparams)
        self.forward_fn = forward
        self.sigmoid = sigmoid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.forward_fn(self.q.tree(), self.norm(x))
        return torch.sigmoid(out) if self.sigmoid else out


class M5Serving(nn.Module):
    """The M5 head: (N, 1, frame) waveform windows -> sigmoid scores."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.model(windows))


def cnn_serving(model, mean=None, std=None) -> CnnServing:
    """The float32 (or bfloat16) head of CnnAvgPooling or MobileNetV1 for
    :func:`aot_export_pipeline`: feats (B, C, T, mel) -> normalize -> model
    -> sigmoid."""
    return CnnServing(model, mean, std)


def quantized_serving(qparams, mean=None, std=None) -> QuantizedServing:
    """The int8 CnnAvgPooling head (``models/quantize.quantize_cnn``'s
    artifact): feats -> normalize -> int8 forward -> sigmoid."""
    from sed_tpu_torch.models.quantize import quantized_cnn_forward

    return QuantizedServing(quantized_cnn_forward, qparams, mean, std)


def mobilenet_quantized_serving(qparams, mean=None, std=None) -> QuantizedServing:
    """The int8 MobileNetV1 head: feats -> normalize -> int8 forward, which
    emits sigmoid scores itself (the reference's forward)."""
    from sed_tpu_torch.models.quantize import quantized_mobilenet_forward

    return QuantizedServing(quantized_mobilenet_forward, qparams, mean, std, sigmoid=False)


def m5_quantized_serving(qparams) -> QuantizedServing:
    """The int8 M5 head: (N, 1, frame) windows -> sigmoid scores."""
    from sed_tpu_torch.models.quantize import quantized_m5_forward

    return QuantizedServing(quantized_m5_forward, qparams)


def m5_serving(model) -> M5Serving:
    """The float32 (or bfloat16) M5 head: (N, 1, frame) windows -> sigmoid
    scores.  Export it with :func:`aot_export_m5_pipeline`, or alone with
    :func:`aot_export_fn` on an (N, 1, frame) float32 input."""
    return M5Serving(model)


# ---------------------------------------------------------------------------
# Export and serialization
# ---------------------------------------------------------------------------

def _graph_nodes(program):
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            yield from gm.graph.nodes


def _check_eval_batch_norm(program) -> None:
    """Every batch norm of the graph uses its running statistics."""
    for node in _graph_nodes(program):
        name = str(node.target)
        if "batch_norm" not in name or "no_training" in name:
            continue
        training = node.args[5] if len(node.args) > 5 else node.kwargs.get("training")
        if "legit_functional" in name or training is not False:
            raise ValueError(f"the exported graph holds a training-mode batch norm "
                             f"({name}): export the model in eval mode")


def _custom_ops(program) -> list:
    """The port's custom operators (``sed_tpu_torch::*``) in ``program``'s
    graph, sorted."""
    return sorted({str(n.target).split(".")[1] for n in _graph_nodes(program)
                   if n.op == "call_function" and str(n.target).startswith("sed_tpu_torch.")})


def _program_input(program):
    """The (fake) tensor of ``program``'s one input: the shape, dtype and
    device it was traced on."""
    (name,) = program.graph_signature.user_inputs
    return next(n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)


def aot_compile_fn(fn: nn.Module, input_spec: torch.Tensor, mesh=None):
    """``torch.export`` ``fn`` (a module with its weights inside) in eval mode
    on an input shaped like ``input_spec`` (a tensor whose shape, dtype and
    device are the input's; its values are not kept).  Returns
    ``(program, input_spec)``, what :func:`serialize_compiled` takes: a
    caller that both measures and ships a program exports it once here.
    Asserts that every batch norm of the graph is in eval mode.

    ``mesh`` (``parallel.mesh.Mesh``): the program is traced on one rank's
    rows of ``input_spec``, (B / mesh.size, ...) on ``mesh.device``, where
    ``fn`` must live; B must divide by the mesh size."""
    spec = input_spec
    if mesh is not None:
        rows = local_rows(mesh, input_spec.shape[0])
        spec = torch.zeros((rows.stop - rows.start, *input_spec.shape[1:]),
                           dtype=input_spec.dtype, device=mesh.device)
    fn.eval()
    program = torch.export.export(fn, (spec,))
    program.example_inputs = None   # the program must not carry a batch of audio
    _check_eval_batch_norm(program)
    return program, input_spec


def serialize_compiled(program, input_spec: torch.Tensor, meta=None) -> bytes:
    """The ``sed_tpu_torch-aot-v1`` container of an :func:`aot_compile_fn`
    program (module docstring).  ``meta``: the caller's JSON-style dict (for
    example ``{"arch": "M5"}``), returned by the loaders as ``call.meta``.
    ``input_spec`` is the global input; the program's own input is one
    rank's shard of it, and their batch sizes give ``n_devices``."""
    shard = _program_input(program)
    n_devices = input_spec.shape[0] // max(1, shard.shape[0])
    if shard.shape[1:] != input_spec.shape[1:] or shard.shape[0] * n_devices != \
            input_spec.shape[0]:
        raise ValueError(f"the program takes {tuple(shard.shape)}, not a shard of "
                         f"{tuple(input_spec.shape)}")
    buf = io.BytesIO()
    torch.export.save(program, buf)
    device = shard.device
    ops = _custom_ops(program)
    library = None
    files = {_PROGRAM: buf.getvalue()}
    if device.type == "cuda" and ops:
        path = kernels.build().path
        data = path.read_bytes()
        library = {"name": path.name, "digest": kernels.library_digest(),
                   "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
        files[path.name] = data
    header = {
        "format": FORMAT, "version": VERSION,
        "input_shape": list(input_spec.shape),
        "input_dtype": str(input_spec.dtype).removeprefix("torch."),
        "n_devices": n_devices, "shard_shape": list(shard.shape),
        "device_type": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "torch_version": torch.__version__, "cuda_version": torch.version.cuda,
        "custom_ops": ops, "kernel_library": library, "meta": dict(meta or {}),
    }
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_HEADER, json.dumps(header, indent=1))
        for name, data in files.items():
            z.writestr(name, data)
    return out.getvalue()


def aot_export_fn(fn: nn.Module, input_spec: torch.Tensor, mesh=None, meta=None) -> bytes:
    """Export and serialize any module ``fn(x) -> y`` with its weights
    inside, traced on ``input_spec``'s device (with a ``mesh``: on one
    rank's rows, on ``mesh.device``, :func:`aot_compile_fn`); loadable by
    :func:`load_aot_pipeline` and :func:`load_aot_fn` in a fresh process."""
    program, spec = aot_compile_fn(fn, input_spec, mesh=mesh)
    return serialize_compiled(program, spec, meta=meta)


class _Pipeline(nn.Module):
    """(batch, samples, channels) PCM -> log-mel (batch, channels, frames,
    mel) -> head."""

    def __init__(self, head, cfg, use_pallas, precision):
        super().__init__()
        self.head, self.cfg = head, cfg
        self.use_pallas, self.precision = use_pallas, precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = logmel_features_batch(x, self.cfg, use_pallas=self.use_pallas,
                                      pallas_precision=self.precision)
        return self.head(feats)


def aot_export_pipeline(head: nn.Module, batch: int, samples: int,
                        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                        pcm_dtype=torch.int16, use_pallas="auto", mesh=None,
                        featurizer_precision=None, meta=None, device="cuda") -> bytes:
    """Export and serialize the whole serving graph of a spectrogram family:
    (batch, samples, 1) ``pcm_dtype`` audio (int16 PCM16, uint8 µ-law or
    float) -> ``logmel_features_batch(use_pallas=...)`` -> ``head`` (from
    :func:`cnn_serving`, :func:`quantized_serving` or
    :func:`mobilenet_quantized_serving`) -> scores (batch, frames',
    classes), traced on ``device``.  With a ``mesh``, the sharded artifact
    of the module docstring, traced on ``mesh.device``; ``batch`` must
    divide by the mesh size.

    ``use_pallas`` 'auto' and 'full' put K1 and K2 in the graph (their
    kernels on CUDA, plain versions on the CPU); True is the PyTorch STFT
    then K2; False PyTorch ops throughout.  ``featurizer_precision``
    (``resolve_featurizer_precision``): None or 'parity', or 'fast', 'turbo'
    or a raw 'bf16xN' string, which bakes K1t into the graph in K1's place,
    as the custom operator ``sed_tpu_torch::wave_dft_power_bf16`` with the
    tier's passes as its arguments (the 'full' path; the others ignore it, as
    sed_tpu's XLA path does)."""
    precision = resolve_featurizer_precision(featurizer_precision)
    device = resolve_device(device) if mesh is None else mesh.device
    spec = torch.zeros((batch, samples, 1), dtype=pcm_dtype, device=device)
    # The featurizer's device tables, made eagerly under the key the traced
    # calls use (the tensor's device, with its index): the graph then holds
    # them as constants, not as host tables copied to the card on every call.
    kernels.stft_window(cfg, spec.device)
    kernels.mel_bands(cfg, spec.device)
    pipeline = _Pipeline(head.to(spec.device), cfg, use_pallas, precision)
    return aot_export_fn(pipeline, spec, mesh=mesh, meta=meta)


class _M5Pipeline(nn.Module):
    """(batch, samples, channels) PCM -> n hop-strided windows of ``frame``
    samples each -> head -> (batch, n, classes)."""

    def __init__(self, head, frame: int, hop: int, n: int):
        super().__init__()
        self.head, self.frame, self.hop, self.n = head, frame, hop, n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        wins = ingest_to_f32(x).transpose(1, 2).unfold(2, self.frame, self.hop)
        wins = wins[:, :, : self.n].permute(0, 2, 1, 3).reshape(b * self.n, c, self.frame)
        return self.head(wins).reshape(b, self.n, -1)


def aot_export_m5_pipeline(head: nn.Module, batch: int, samples: int, cfg=None,
                           pcm_dtype=torch.int16, mesh=None, meta=None,
                           device="cuda") -> bytes:
    """Export and serialize the waveform family's serving graph: (batch,
    samples, 1) PCM -> the hop-strided windows of the offline validation
    split (``frame = 2 * (frame_size // 2)``, ``n = (samples - frame) //
    hop + 1``) -> ``head`` (:func:`m5_serving` or
    :func:`m5_quantized_serving`) -> (batch, n, classes) scores.  The
    windows come from ``unfold``; uint8 input is µ-law, as everywhere in
    the repository.  ``mesh``: as :func:`aot_export_pipeline`'s."""
    from sed_tpu_torch.configs import DEFAULT_WAVEFORM

    cfg = cfg or DEFAULT_WAVEFORM
    frame = 2 * (cfg.frame_size // 2)
    n = (samples - frame) // cfg.hop_size + 1
    if n < 1:
        raise ValueError(f"samples={samples} yields no {frame}-sample frame")
    device = resolve_device(device) if mesh is None else mesh.device
    pipeline = _M5Pipeline(head.to(device), frame, cfg.hop_size, n)
    spec = torch.zeros((batch, samples, 1), dtype=pcm_dtype, device=device)
    return aot_export_fn(pipeline, spec, mesh=mesh, meta=meta)


def _export_head(head: nn.Module, batch: int, frames: int, cfg, device) -> bytes:
    device = resolve_device(device)
    spec = torch.zeros((batch, 1, frames, cfg.mel_bins), device=device)
    program, spec = aot_compile_fn(head.to(device), spec)
    return serialize_compiled(program, spec)


def export_scorer(model, batch: int, frames: int,
                  cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM, device="cuda") -> bytes:
    """Serialize a (batch, 1, frames, mel) -> (batch, frames', classes)
    sigmoid scorer of a spectrogram CNN with its weights inside (the port's
    NCHW layout; ``sed_tpu``'s scorer takes NHWC).  It holds no kernel."""
    return _export_head(cnn_serving(model), batch, frames, cfg, device)


def export_quantized_scorer(qparams, batch: int, frames: int,
                            cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                            device="cuda") -> bytes:
    """Serialize the int8 scorer of either spectrogram family's artifact
    (``models/quantize.py``): (batch, 1, frames, mel) -> sigmoid scores,
    the int8 weights and scales inside."""
    from sed_tpu_torch.models.quantize import quantized_serving_scores

    head = QuantizedServing(quantized_serving_scores, qparams, sigmoid=False)
    return _export_head(head, batch, frames, cfg, device)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def _read_container(blob: bytes):
    """(header, {name: bytes}) of a ``sed_tpu_torch-aot-v1`` artifact.  A
    ``sed_tpu`` pickle is recognised by its first byte and refused without
    being unpickled."""
    blob = bytes(blob)
    if blob[:1] == b"\x80":
        raise ValueError(
            "this is a pickle (sed_tpu's sed_tpu-aot-v1 artifact holds a compiled XLA "
            "executable, which cannot run here); it is not unpickled.  Build a "
            "sed_tpu_torch artifact with `python -m sed_tpu_torch.cli.serve build`")
    if blob[:4] != b"PK\x03\x04":
        raise ValueError(f"not a {FORMAT} artifact (no zip container)")
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        files = {name: z.read(name) for name in z.namelist()}
    try:
        header = json.loads(files.pop(_HEADER))
    except KeyError:
        raise ValueError(f"not a {FORMAT} artifact (no {_HEADER})") from None
    if header.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact: format {header.get('format')!r}")
    return header, files


def _target_device(header, device=None, mesh=None) -> torch.device:
    """The device an artifact is loaded on: ``mesh.device`` under a mesh,
    else ``device`` (None: the device type it was traced on); another
    device type than the traced one is refused."""
    traced = header["device_type"]
    if mesh is not None:
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's ({mesh.device})")
        device = mesh.device
    device = resolve_device(traced if device is None else device)
    if device.type != traced:
        raise ValueError(f"this artifact was traced on {traced} and runs only there, "
                         f"not on {device.type}: its featurizer and int8 products "
                         f"picked their {traced} kernels when it was exported")
    return device


def _check_n_devices(header, device: torch.device) -> int:
    """The artifact's device count (1 without the field, as ``sed_tpu``
    reads it); a CUDA host with fewer cards is refused with ``sed_tpu``'s
    message (the CPU takes any number of gloo ranks)."""
    n = int(header.get("n_devices", 1))
    if n > 1 and device.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"artifact was compiled for {n} devices; this host has "
                         f"{torch.cuda.device_count()}")
    return n


def artifact_devices(blob: bytes, device=None) -> int:
    """The number of devices (ranks) an artifact was exported for, after
    the checks :func:`load_aot_pipeline` makes of ``device`` first (its
    type, and enough CUDA cards): what ``cli/serve.py run`` launches."""
    header, _ = _read_container(blob)
    return _check_n_devices(header, _target_device(header, device))


def place_program(program, device: torch.device):
    """``program`` on ``device`` (``move_to_device_pass``): its weights, its
    constants, the device arguments of its nodes (the input's
    ``_assert_tensor_metadata`` among them) and their tensor metadata, all
    of which name the tracing device otherwise."""
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device)


def _load(blob: bytes, device=None, mesh=None):
    """The artifact's module, its header, the device and the seconds of each
    loading stage, as a callable's attributes; the callable runs the module
    without autograd and in full float32 (an exported program carries no
    backend flags, so TF32 would otherwise follow the caller's).  It takes
    the global batch (a tensor on any device) and returns the global
    scores on its device: for an N-device artifact it runs this rank's
    rows (``local_rows``) and gathers every rank's scores after
    (``gather_rows``).

    ``device`` None is the device type the artifact was traced on; another
    type is refused.  ``mesh``: this rank's mesh; the program is placed on
    ``mesh.device``.  An artifact of N > 1 devices needs a mesh of N ranks
    and, on CUDA, N cards; a 1-device artifact on a larger mesh scores the
    whole batch on each rank.  A kernel library of another
    ``featurizer.cu`` is refused; a missing one is installed from the
    artifact into ``_build/`` (no ``nvcc``).  ``load_timings``: ``read``
    (the container), ``library`` (its install), ``device`` (the card's
    context, which the program's weights need), ``program``
    (``torch.export.load``), ``place`` (:func:`place_program`) and
    ``module`` (the callable module)."""
    t = [time.perf_counter()]
    timings = {}

    def stage(name):
        now = time.perf_counter()
        timings[name] = now - t[0]
        t[0] = now

    header, files = _read_container(blob)
    device = _target_device(header, device, mesh)
    n_devices = _check_n_devices(header, device)
    if n_devices > 1 and (mesh is None or mesh.size != n_devices):
        raise ValueError(
            f"artifact was compiled for {n_devices} devices: each rank of a "
            f"{n_devices}-rank mesh loads it with mesh= (parallel.mesh.create_mesh"
            f"({n_devices})); got " + ("no mesh" if mesh is None else
                                       f"a mesh of {mesh.size}"))
    # A mesh of the artifact's size shards the batch (at world size 1 too, so
    # that one card runs the gather); a 1-device artifact on a larger mesh
    # scores the whole batch on each rank.
    shards = mesh if mesh is not None and mesh.size == n_devices else None
    lib = header.get("kernel_library")
    if lib and lib["digest"] != kernels.library_digest():
        raise ValueError(
            f"the artifact's kernel library {lib['digest']} was built from another "
            f"featurizer.cu than this checkout's ({kernels.library_digest()}); "
            f"rebuild the artifact with this checkout")
    stage("read")
    if lib:
        kernels.install_library(files[lib["name"]], lib["digest"], lib["sha256"])
    stage("library")
    torch.empty(0, device=device)
    if device.type == "cuda" and device.index is None:   # the placement names an index
        device = torch.device("cuda", torch.cuda.current_device())
    stage("device")
    program = torch.export.load(io.BytesIO(files[_PROGRAM]))
    stage("program")
    program = place_program(program, device)
    stage("place")
    module = program.module()
    stage("module")

    def run(x):
        local = x[local_rows(shards, x.shape[0])].to(device)
        with torch.inference_mode(), full_float32():
            out = module(local)
        return gather_rows(shards, out)

    run.input_shape = tuple(header["input_shape"])
    run.input_dtype = header["input_dtype"]
    run.n_devices = n_devices
    run.shard_shape = tuple(header.get("shard_shape", header["input_shape"]))
    run.device_kind = header["device_kind"]
    run.torch_version = header["torch_version"]
    run.meta = header.get("meta", {})
    run.header, run.module, run.device, run.load_timings = header, module, device, timings
    return run


def _attach(call, loaded):
    """``call`` with the attributes of :func:`_load`'s callable."""
    for name in ("input_shape", "input_dtype", "n_devices", "shard_shape", "device_kind",
                 "torch_version", "meta", "header", "module", "device", "load_timings"):
        setattr(call, name, getattr(loaded, name))
    return call


def load_aot_fn(blob: bytes, device=None, mesh=None):
    """An artifact as a raw device-level callable, ``call(x) -> y`` on
    tensors already on its device, with no host conversion on either side
    (the measurement path).  With ``mesh`` (each rank of it calls this):
    ``x`` is the global batch every rank holds, ``y`` the global scores,
    gathered (module docstring).  Same trust caveat as
    :func:`load_aot_pipeline`."""
    return _load(blob, device, mesh)


def _bridge(audio: np.ndarray, dtype: str) -> np.ndarray:
    """The host-side value-preserving dtype bridge (int16 means PCM16, uint8
    µ-law): a bare cast would truncate float [-1, 1] audio to silence."""
    want = np.dtype(dtype)
    if audio.dtype == want:
        return audio
    if want == np.int16 and np.issubdtype(audio.dtype, np.floating):
        return np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    if np.issubdtype(want, np.floating) and audio.dtype == np.int16:
        return audio.astype(want) / np.asarray(32768.0, want)
    if np.issubdtype(want, np.floating) and np.issubdtype(audio.dtype, np.floating):
        return audio.astype(want)   # e.g. float64 wav decode -> f32
    if want == np.uint8 and (audio.dtype == np.int16
                             or np.issubdtype(audio.dtype, np.floating)):
        from sed_tpu_torch.ops.mulaw import mulaw_encode

        return mulaw_encode(audio)
    raise ValueError(f"artifact expects {dtype} audio, got {audio.dtype}")


def load_aot_pipeline(blob: bytes, device=None, mesh=None):
    """Load an :func:`aot_export_pipeline` / :func:`aot_export_m5_pipeline` /
    :func:`aot_export_fn` artifact; returns ``call(audio) -> scores``
    (numpy in, numpy out) that runs the exported program with no compile
    and no ``nvcc``.  ``device``: None (the device type the artifact was
    traced on) or that type; any other is refused.  ``mesh``: this rank's
    mesh, which an N-device artifact needs (N ranks; on CUDA, N cards, or
    ``sed_tpu``'s refusal): every rank calls with the same global audio,
    uploads its own rows and returns every rank's scores.

    The callable has ``input_shape`` (the global batch's), ``input_dtype``,
    ``n_devices``, ``shard_shape``, ``device_kind``, ``meta`` and
    ``header`` attributes.  Audio of another shape is refused; another
    dtype goes through the host bridge (float -> PCM16, PCM16 -> float,
    float64 -> float32, int16 or float -> µ-law).

    .. warning:: a CUDA artifact carries a native library, which this
       installs and runs.  Load TRUSTED artifacts only (ones you built).
    """
    run = _load(blob, device, mesh)
    shape, dtype = run.input_shape, run.input_dtype

    def call(audio):
        audio = np.asarray(audio)
        if audio.shape != shape:
            raise ValueError(f"artifact expects audio {shape} {dtype}, got {audio.shape}")
        return run(torch.from_numpy(np.ascontiguousarray(_bridge(audio, dtype)))).cpu().numpy()

    return _attach(call, run)


def load_scorer(blob: bytes, device=None, mesh=None):
    """Load an exported scorer; returns ``call(x) -> scores`` over numpy
    arrays or tensors of (batch, 1, frames, mel) float32 features.
    ``device`` and ``mesh`` as :func:`load_aot_pipeline`'s."""
    run = _load(blob, device, mesh)

    def call(x):
        return run(torch.as_tensor(np.asarray(x, np.float32))).cpu().numpy()

    return _attach(call, run)

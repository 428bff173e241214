"""PyTorch + CUDA port of sed_tpu, for NVIDIA Hopper (H100).

The module paths mirror ``sed_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and scipy only; it never imports JAX or
anything of ``sed_tpu`` and keeps its own copies of what it needs.

Covered so far (scoring and streaming; training is not ported yet):

  configs:    AudioConfig, SpectrogramConfig, WaveformConfig
  features:   logmel_features(_batch), multichannel_stft,
              multichannel_complex_to_log_mel -> ops.cuda_featurizer
              (hand-written CUDA kernels on CUDA tensors, their plain
              PyTorch versions on CPU tensors)
  models:     CnnAvgPooling, MobileNetV1, M5, models.convert (sed_tpu
              weights in), models.describe
  inference:  batch_predict_files, windowed_forward (one long recording),
              StreamingDetector, DeviceStreamingDetector, StreamPool,
              StreamServer / StreamClient
  CLIs:       python -m sed_tpu_torch.cli.infer (windowed per file, --batch,
              --arch CnnAvgPooling|MobileNetV1|M5), cli.stream,
              cli.serve_socket

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Top-level names are imported lazily, so ``import sed_tpu_torch`` stays light.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "AudioConfig": "sed_tpu_torch.configs",
    "SpectrogramConfig": "sed_tpu_torch.configs",
    "WaveformConfig": "sed_tpu_torch.configs",
    "logmel_features": "sed_tpu_torch.ops.featurizer",
    "logmel_features_batch": "sed_tpu_torch.ops.featurizer",
    "multichannel_stft": "sed_tpu_torch.ops.featurizer",
    "multichannel_complex_to_log_mel": "sed_tpu_torch.ops.featurizer",
    "CnnAvgPooling": "sed_tpu_torch.models.cnn",
    "MobileNetV1": "sed_tpu_torch.models.cnn",
    "M5": "sed_tpu_torch.models.m5",
    "batch_predict_files": "sed_tpu_torch.inference",
    "StreamingDetector": "sed_tpu_torch.streaming",
    "BatchedStreamingDetector": "sed_tpu_torch.streaming",
    "make_stream_fns": "sed_tpu_torch.streaming",
    "DeviceStreamingDetector": "sed_tpu_torch.device_streaming",
    "StreamPool": "sed_tpu_torch.stream_pool",
    "StreamServer": "sed_tpu_torch.serve_socket",
    "StreamClient": "sed_tpu_torch.serve_socket",
    "windowed_forward": "sed_tpu_torch.parallel.time_shard",
    "extract_events": "sed_tpu_torch.utils.events_post",
    "mulaw_encode": "sed_tpu_torch.ops.mulaw",
    "mulaw_decode": "sed_tpu_torch.ops.mulaw",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module 'sed_tpu_torch' has no attribute '{name}'")


def __dir__():
    return sorted(list(_EXPORTS) + ["__version__"])

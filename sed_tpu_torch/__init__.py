"""PyTorch + CUDA port of sed_tpu, for NVIDIA Hopper (H100).

The module paths mirror ``sed_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and scipy only; it never imports JAX or
anything of ``sed_tpu`` and keeps its own copies of what it needs.

Covered so far (scoring, streaming and training of all three model
families, int8 PTQ and QAT, the bf16 tier, AOT serving artifacts, data
parallelism, the SVM baseline and the exploration scripts):

  configs:    AudioConfig, SpectrogramConfig, WaveformConfig
  features:   logmel_features(_batch), multichannel_stft,
              multichannel_complex_to_log_mel -> ops.cuda_featurizer
              (hand-written CUDA kernels on CUDA tensors, their plain
              PyTorch versions on CPU tensors)
  data:       SpectrogramDataset, WaveformDataset, preprocess_data
              (workers > 0: the native reader's threads)
  audio I/O:  io.audio (WAV decode through io.native, the port's own copy
              of the C++ reader, built with g++ at first use)
  models:     CnnAvgPooling, MobileNetV1, M5, models.convert (sed_tpu
              weights and int8 artifacts in), models.describe
  int8:       quantize_cnn, quantized_scores (models.quantize, with
              MobileNetV1's and M5's), qat_init, qat_finetune, qat_export
              (models.qat); int8 products in ops.int8 (torch._int_mm on CUDA)
  training:   train, evaluate, make_optimizer, save_checkpoint,
              load_checkpoint
  metrics:    calculate_metrics, f_score, event_based_metrics,
              event_metrics_from_scores
  inference:  batch_predict_files, windowed_forward (one long recording),
              StreamingDetector, DeviceStreamingDetector, StreamPool,
              (Batched)WaveformStreamingDetector, WaveformStreamPool (M5),
              StreamServer / StreamClient
  checkpoints: cli.infer.load_model_and_state (port .pt, reference .pth,
              sed_tpu .ckpt and .ckpt.orbax; bf16=True the bf16 tier), train.torch_import /
              torch_export
  parallel:   parallel.mesh (create_mesh, shard_batch, replicate),
              parallel.data_parallel (shard_train_step, shard_inference),
              parallel.multihost (initialize_multihost, launch): one rank a
              device on torch.distributed; mesh= in train, the batch
              predictors and the pools
  serving:    export (aot_export_pipeline, aot_export_m5_pipeline,
              load_aot_pipeline, export_scorer, load_scorer: torch.export
              programs with K1 and K2 as custom operators)
  classical:  classical.svm (SVMDetector: scikit-learn's weighted RBF SVC
              with libsvm's probabilities, solved on the device by
              classical.svc; featurize_frames, get_raw_data, the CLI)
  scripts:    python -m sed_tpu_torch.scripts.analyze_spectogram,
              .play_with_spectograms, .plot_waveform_frames
  CLIs:       python -m sed_tpu_torch.cli.main (--train_features
              Waveform or Spectogram, --bf16, --preprocess_workers), python
              -m sed_tpu_torch.cli.infer (windowed per file, --batch, --arch
              CnnAvgPooling|MobileNetV1|M5, --quantize int8, --bf16),
              cli.stream, cli.serve_socket (--arch, --m5_pool, --quantize
              int8, --bf16), cli.serve (build, run), cli.import_torch,
              cli.export_torch; --num_devices in cli.main, cli.infer
              --batch and cli.stream

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
    "SpectrogramDataset": "sed_tpu_torch.data.spectrogram_dataset",
    "WaveformDataset": "sed_tpu_torch.data.waveform_dataset",
    "preprocess_data": "sed_tpu_torch.data.preprocess",
    "CnnAvgPooling": "sed_tpu_torch.models.cnn",
    "MobileNetV1": "sed_tpu_torch.models.cnn",
    "M5": "sed_tpu_torch.models.m5",
    "quantize_cnn": "sed_tpu_torch.models.quantize",
    "quantized_scores": "sed_tpu_torch.models.quantize",
    "qat_init": "sed_tpu_torch.models.qat",
    "qat_finetune": "sed_tpu_torch.models.qat",
    "qat_export": "sed_tpu_torch.models.qat",
    "train": "sed_tpu_torch.train.loop",
    "evaluate": "sed_tpu_torch.train.loop",
    "make_optimizer": "sed_tpu_torch.train.optim",
    "save_checkpoint": "sed_tpu_torch.train.checkpoint",
    "load_checkpoint": "sed_tpu_torch.train.checkpoint",
    "batch_predict_files": "sed_tpu_torch.inference",
    "StreamingDetector": "sed_tpu_torch.streaming",
    "BatchedStreamingDetector": "sed_tpu_torch.streaming",
    "make_stream_fns": "sed_tpu_torch.streaming",
    "DeviceStreamingDetector": "sed_tpu_torch.device_streaming",
    "StreamPool": "sed_tpu_torch.stream_pool",
    "WaveformStreamingDetector": "sed_tpu_torch.waveform_streaming",
    "BatchedWaveformStreamingDetector": "sed_tpu_torch.waveform_streaming",
    "WaveformStreamPool": "sed_tpu_torch.waveform_streaming",
    "StreamServer": "sed_tpu_torch.serve_socket",
    "StreamClient": "sed_tpu_torch.serve_socket",
    "windowed_forward": "sed_tpu_torch.parallel.time_shard",
    "create_mesh": "sed_tpu_torch.parallel.mesh",
    "calculate_metrics": "sed_tpu_torch.utils.metrics",
    "f_score": "sed_tpu_torch.utils.metrics",
    "event_based_metrics": "sed_tpu_torch.utils.event_metrics",
    "event_metrics_from_scores": "sed_tpu_torch.utils.event_metrics",
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

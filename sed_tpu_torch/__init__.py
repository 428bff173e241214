"""PyTorch + CUDA port of sed_tpu, for NVIDIA Hopper (H100).

The module paths mirror ``sed_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and scipy only; it never imports JAX or
anything of ``sed_tpu`` and keeps its own copies of what it needs.

Covered so far (the batch-scoring path):

  configs:    AudioConfig, SpectrogramConfig
  features:   ops.featurizer.logmel_features(_batch) -> ops.cuda_featurizer
              (hand-written CUDA STFT-power and mel-log kernels on CUDA
              tensors, their plain PyTorch versions on CPU tensors)
  models:     models.cnn.CnnAvgPooling, models.convert (sed_tpu weights in)
  inference:  inference.make_batch_predictor, inference.batch_predict_files
  CLI:        python -m sed_tpu_torch.cli.infer --batch

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

"""Featurizer ops: STFT, mel filterbank, µ-law ingest and the CUDA kernels."""

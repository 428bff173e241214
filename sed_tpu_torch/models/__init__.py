"""Spectrogram models (NCHW ``nn.Module``s) and weight conversion."""

"""Command-line entry points (``python -m sed_tpu_torch.cli.<name>``)."""

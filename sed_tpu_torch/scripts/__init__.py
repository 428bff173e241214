"""The exploration scripts of the repository root, ported: run each as
``python -m sed_tpu_torch.scripts.<name>`` with the root script's flags plus
``--device`` (default ``cuda``) and ``--no_plot`` (write arrays instead of
PNGs; a plot asked for without matplotlib is refused before any work)."""

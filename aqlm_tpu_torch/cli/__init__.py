"""Command-line entry points of the port (``python -m aqlm_tpu_torch.cli.<name>``)."""

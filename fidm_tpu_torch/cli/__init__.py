"""Command-line entry points of the port (`python -m fidm_tpu_torch.cli.<name>`)."""

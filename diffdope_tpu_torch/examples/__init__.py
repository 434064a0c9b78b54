"""The port's command-line entry points, run as modules:
``python -m diffdope_tpu_torch.examples.<name> ...``."""

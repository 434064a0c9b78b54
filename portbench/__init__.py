"""The benchmark of the PyTorch and CUDA port (``diffdope_tpu_torch``)."""

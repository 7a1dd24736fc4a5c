"""A benchmark of the PyTorch/CUDA port (``artist_tpu_torch``): harness, traffic, reference and metric readers."""

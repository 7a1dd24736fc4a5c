"""Measurement tools of the port, each run as ``python3 -m artist_tpu_torch.tools.<name>``."""

"""Runnable examples of the port (``python -m artist_tpu_torch.examples.<name>``)."""

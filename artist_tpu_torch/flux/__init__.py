"""Flux bitmap post-processing (counterpart of ``artist_tpu/flux``)."""

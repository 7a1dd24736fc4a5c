from artist_tpu_torch.optim import losses  # noqa: F401

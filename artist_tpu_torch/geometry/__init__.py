from artist_tpu_torch.geometry import rotations, transforms  # noqa: F401

from artist_tpu_torch.scene.sun import Sun  # noqa: F401

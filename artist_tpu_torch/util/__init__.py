from artist_tpu_torch.util import config, constants, indices  # noqa: F401

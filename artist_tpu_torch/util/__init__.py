from artist_tpu_torch.util import constants, indices  # noqa: F401

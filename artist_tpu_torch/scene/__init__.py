from artist_tpu_torch.scene.rays import Rays  # noqa: F401
from artist_tpu_torch.scene.sun import Sun  # noqa: F401

from artist_tpu_torch.raytracing.blocking import soft_ray_blocking_mask  # noqa: F401
from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays  # noqa: F401

from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays  # noqa: F401

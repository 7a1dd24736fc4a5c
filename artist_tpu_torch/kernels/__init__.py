"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch versions."""

from artist_tpu_torch.kernels.blocking import blocking_sigma
from artist_tpu_torch.kernels.splat import BilinearSplat, splat

__all__ = ["BilinearSplat", "blocking_sigma", "splat"]

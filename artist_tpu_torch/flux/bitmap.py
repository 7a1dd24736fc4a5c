"""Flux bitmap post-processing (counterpart of ``artist_tpu/flux/bitmap.py``).

Only the trapezoid target distribution of the aim-point optimizer is ported
so far; the center of mass and the crop come with the surface reconstructor.
"""

from __future__ import annotations

import torch


def trapezoid_distribution(
    total_width: int,
    slope_width: int,
    plateau_width: int,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """One-dimensional trapezoid target distribution ``[total_width]``: a plateau of
    ``plateau_width`` in the middle, falling linearly to 0 over ``slope_width``."""
    index_range = torch.arange(total_width, dtype=torch.float32, device=device)
    center = (total_width - 1) / 2.0
    distances = torch.abs(index_range - center) - plateau_width / 2.0
    if slope_width == 0:
        return (distances <= 0).to(torch.float32)
    return 1.0 - torch.clamp(distances / slope_width, 0.0, 1.0)

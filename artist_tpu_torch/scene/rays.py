"""The ray value type: directions and magnitudes of scattered rays.

Counterpart of ``artist_tpu/scene/rays.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Rays:
    """A bundle of scattered rays.

    Attributes
    ----------
    ray_directions : torch.Tensor
        ``[M, R, P, 4]``.
    ray_magnitudes : torch.Tensor
        ``[M, R, P]``.
    """

    ray_directions: torch.Tensor
    ray_magnitudes: torch.Tensor

    def __post_init__(self):
        if self.ray_directions.ndim >= 1 and self.ray_directions.shape[:-1] != self.ray_magnitudes.shape:
            raise ValueError(
                "ray_directions and ray_magnitudes shapes are inconsistent: "
                f"{tuple(self.ray_directions.shape)} vs {tuple(self.ray_magnitudes.shape)}"
            )

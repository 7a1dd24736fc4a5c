"""Solar tower with planar and cylindrical target areas.

Counterpart of ``artist_tpu/field/solar_tower.py``: one dataclass of
tensors holding both target-area families. The global target index orders
planar areas first, then cylindrical ones.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolarTower:
    """All tower target areas of a scenario."""

    planar_centers: torch.Tensor  # [Tp, 4]
    planar_normals: torch.Tensor  # [Tp, 4]
    planar_dimensions: torch.Tensor  # [Tp, 2] (width plane_e, height plane_u)

    cylindrical_centers: torch.Tensor  # [Tc, 4]
    cylindrical_axes: torch.Tensor  # [Tc, 4]
    cylindrical_normals: torch.Tensor  # [Tc, 4]
    cylindrical_radii: torch.Tensor  # [Tc]
    cylindrical_heights: torch.Tensor  # [Tc]
    cylindrical_opening_angles: torch.Tensor  # [Tc]

    planar_names: tuple = ()
    cylindrical_names: tuple = ()

    @property
    def number_of_planar_target_areas(self) -> int:
        return self.planar_centers.shape[0]

    @property
    def number_of_cylindrical_target_areas(self) -> int:
        return self.cylindrical_centers.shape[0]

    @property
    def number_of_target_areas(self) -> int:
        return self.number_of_planar_target_areas + self.number_of_cylindrical_target_areas

    @property
    def names(self) -> tuple:
        return self.planar_names + self.cylindrical_names

    @property
    def target_name_to_index(self) -> dict:
        """Global name -> index mapping (planar first)."""
        return {name: i for i, name in enumerate(self.names)}


def get_centers_of_target_areas(
    tower: SolarTower, target_area_indices: torch.Tensor
) -> torch.Tensor:
    """Homogeneous center coordinates ``[M, 4]`` of the indexed target areas.

    Planar centers are returned directly; cylindrical centers are offset
    outward along the surface normal by the radius (the point on the curved
    surface facing the field).
    """
    n_planar = tower.number_of_planar_target_areas
    planar_mask = (target_area_indices < n_planar)[:, None]

    centers = torch.zeros(
        (target_area_indices.shape[0], 4),
        dtype=torch.float32,
        device=target_area_indices.device,
    )
    if n_planar > 0:
        p_idx = torch.clamp(target_area_indices, 0, n_planar - 1)
        centers = torch.where(planar_mask, tower.planar_centers[p_idx], centers)
    if tower.number_of_cylindrical_target_areas > 0:
        c_idx = torch.clamp(
            target_area_indices - n_planar,
            0,
            tower.number_of_cylindrical_target_areas - 1,
        )
        cyl_centers = (
            tower.cylindrical_centers[c_idx]
            + tower.cylindrical_radii[c_idx][:, None] * tower.cylindrical_normals[c_idx]
        )
        centers = torch.where(planar_mask, centers, cyl_centers)
    centers[:, 3] = 1.0
    return centers

"""Ray-target intersection geometry: reflection and planar-target hits.

Counterpart of ``artist_tpu/raytracing/geometry.py``. Branch-free: the
"no intersection" cases become mask algebra, and each division that can
meet a masked-out zero takes a safe denominator first, so gradients stay
finite. ``line_cylinder_intersections`` is not ported yet; the renderer
refuses cylindrical targets.
"""

from __future__ import annotations

import torch

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.util import indices


def reflect(
    incident_ray_directions: torch.Tensor, reflection_surface_normals: torch.Tensor
) -> torch.Tensor:
    """Mirror reflection: d - 2 (d.n) n."""
    return (
        incident_ray_directions
        - 2.0
        * torch.sum(
            incident_ray_directions * reflection_surface_normals, dim=-1, keepdim=True
        )
        * reflection_surface_normals
    )


def line_plane_intersections(
    ray_directions: torch.Tensor,
    ray_magnitudes: torch.Tensor | float,
    points_at_ray_origins: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    bitmap_resolution: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ray/planar-target intersections in continuous bitmap coordinates.

    Lambert cosine intensities, front-face masking, in-bounds masking, and
    the e-axis flip ("viewed from the field"). Invalid rays are zeroed before
    the flip, so they arrive at ``e = W - 1``, which the splat's strict
    ``floor(e) <= W - 2`` bound rejects.

    Parameters
    ----------
    ray_directions : torch.Tensor
        Normalized ray directions ``[M, R, P, 4]``.
    ray_magnitudes : torch.Tensor | float
        Broadcastable to ``[M, R, P]``.
    points_at_ray_origins : torch.Tensor
        Ray origins (= aligned surface points) ``[M, P, 4]``.
    tower : SolarTower
        Target-area tensors.
    target_area_indices : torch.Tensor
        Planar target index per heliostat ``[M]``.
    bitmap_resolution : tuple[int, int]
        (width_e, height_u).

    Returns
    -------
    tuple of torch.Tensor
        (bitmap_e, bitmap_u, intersection_distances, intensities), each
        ``[M, R, P]``.
    """
    directions = ray_directions[..., :3]
    origins = points_at_ray_origins[..., :3]
    plane_normals = tower.planar_normals[target_area_indices][..., :3]
    plane_centers = tower.planar_centers[target_area_indices]

    # Lambert cosine: rays hit the front face when the dot product with the
    # outward plane normal is negative.
    angle_based_intensities = torch.sum(
        directions * plane_normals[:, None, None, :], dim=-1
    )
    front_facing = angle_based_intensities < 0.0

    numerator = torch.sum(
        (plane_centers[:, None, :3] - origins) * plane_normals[:, None, :], dim=-1
    )[:, None, :]
    safe_denominator = torch.where(
        front_facing, angle_based_intensities, torch.ones_like(angle_based_intensities)
    )
    intersection_distances = (numerator / safe_denominator) * front_facing

    intersections = origins[:, None, :, :] + directions * intersection_distances[..., None]

    intensities = ray_magnitudes * -angle_based_intensities

    plane_dimensions = tower.planar_dimensions[target_area_indices]
    width = plane_dimensions[:, indices.target_dimensions_width, None, None]
    height = plane_dimensions[:, indices.target_dimensions_height, None, None]

    target_e = (
        intersections[..., indices.e] + width / 2 - plane_centers[:, indices.e, None, None]
    )
    target_u = (
        intersections[..., indices.u] + height / 2 - plane_centers[:, indices.u, None, None]
    )

    res_e, res_u = bitmap_resolution
    bitmap_e = target_e / width * (res_e - 1)
    bitmap_u = target_u / height * (res_u - 1)

    valid = (
        (0 <= bitmap_e)
        & (bitmap_e <= res_e - 1)
        & (0 <= bitmap_u)
        & (bitmap_u <= res_u - 1)
        & front_facing
    )
    bitmap_e = bitmap_e * valid
    bitmap_u = bitmap_u * valid
    intersection_distances = intersection_distances * valid
    intensities = intensities * valid

    # Flip left-right: flux bitmaps are viewed from the heliostat field.
    bitmap_e = (res_e - 1) - bitmap_e

    return bitmap_e, bitmap_u, intersection_distances, intensities

"""Ray-target intersection geometry: reflection, planar and cylindrical hits.

Counterpart of ``artist_tpu/raytracing/geometry.py``. Branch-free: the
"no intersection" cases become mask algebra, and each division that can
meet a masked-out zero takes a safe denominator first, so gradients stay
finite.
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


def _dot3(vectors: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``sum_j vectors[..., j] * rows[m, j]`` with ``rows`` ``[M, 3]`` broadcast over
    the middle axes of ``vectors`` ``[M, ..., 3]``: elementwise fp32, whatever
    the matmul precision setting."""
    shape = (rows.shape[0],) + (1,) * (vectors.dim() - 2) + (3,)
    return torch.sum(vectors * rows.reshape(shape), dim=-1)


def line_cylinder_intersections(
    ray_directions: torch.Tensor,
    ray_magnitudes: torch.Tensor | float,
    points_at_ray_origins: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    bitmap_resolution: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ray/cylindrical-receiver intersections in continuous bitmap coordinates.

    In each cylinder's local frame (rows ``normal x axis``, ``normal``,
    ``axis``; the change of frame in fp32): the quadratic in the distance,
    the smaller positive root (``+1e-12`` under the square root), the finite
    patch of the cylinder's height and opening angle, and Lambert intensities
    against the outward surface normal. The angle is ``atan2(y, x) -
    (normal_angle - opening / 2)`` with no wrap to ``[0, 2 pi)``. Rays that
    miss keep coordinates, distance and intensity 0. No left-right flip.

    Parameters are those of :func:`line_plane_intersections`, with
    cylinder-local target indices ``[M]``; returns the same quadruple.
    """
    origins = points_at_ray_origins[..., :3]
    directions = ray_directions[..., :3]

    axes = tower.cylindrical_axes[target_area_indices][:, :3]
    normals = tower.cylindrical_normals[target_area_indices][:, :3]
    centers = tower.cylindrical_centers[target_area_indices][:, :3]
    radii = tower.cylindrical_radii[target_area_indices][:, None, None]
    heights = tower.cylindrical_heights[target_area_indices][:, None, None]
    opening_angles = tower.cylindrical_opening_angles[target_area_indices][:, None, None]

    frame = (torch.linalg.cross(normals, axes, dim=-1), normals, axes)
    relative = origins - centers[:, None, :]  # [M, P, 3]
    origins_local = [_dot3(relative, row)[:, None, :] for row in frame]  # [M, 1, P] each
    directions_local = [_dot3(directions, row) for row in frame]  # [M, R, P] each
    ox, oy, oz = origins_local
    dx, dy, dz = directions_local

    a = dx**2 + dy**2
    b = 2.0 * (ox * dx + oy * dy)
    c = ox**2 + oy**2 - radii**2

    discriminant = b**2 - 4.0 * a * c
    solvable = torch.abs(a) > 1e-8
    hits_infinite = (discriminant >= 0) & solvable

    sqrt_discriminant = torch.sqrt(discriminant * hits_infinite + 1e-12)
    safe_a = torch.where(solvable, a, torch.ones_like(a))
    infinity = torch.full_like(a, float("inf"))
    near = (-b - sqrt_discriminant) / (2.0 * safe_a)
    far = (-b + sqrt_discriminant) / (2.0 * safe_a)
    near = torch.where(near > 0, near, infinity)
    far = torch.where(far > 0, far, infinity)
    intersection_distances = torch.minimum(near, far)
    valid = torch.isfinite(intersection_distances) & hits_infinite
    intersection_distances = torch.where(
        valid, intersection_distances, torch.zeros_like(intersection_distances)
    )

    x = ox + intersection_distances * dx
    y = oy + intersection_distances * dy
    z = oz + intersection_distances * dz

    normal_norm = torch.sqrt(x**2 + y**2)
    safe_norm = torch.where(normal_norm > 0, normal_norm, torch.ones_like(normal_norm))
    # Lambert: -(d . n_local) with n_local = (x, y, 0) / |(x, y)|.
    angle_based = torch.clamp(-(dx * x + dy * y) / safe_norm, min=0.0)

    z = z + heights / 2
    normal_angle = torch.atan2(normals[:, 1], normals[:, 0])[:, None, None]
    angles = torch.atan2(y, x) - (normal_angle - opening_angles / 2)

    on_patch = (z >= 0) & (z <= heights) & (angles >= 0) & (angles <= opening_angles)

    res_e, res_u = bitmap_resolution
    bitmap_u = z / heights * (res_u - 1)
    bitmap_e = angles / opening_angles * (res_e - 1)

    mask = on_patch & valid
    bitmap_e = bitmap_e * mask
    bitmap_u = bitmap_u * mask
    intersection_distances = intersection_distances * mask
    intensities = ray_magnitudes * angle_based * mask
    return bitmap_e, bitmap_u, intersection_distances, intensities

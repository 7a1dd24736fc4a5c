"""Coordinate conversions: 3D/4D homogeneous, azimuth/elevation, WGS84, bitmap to world.

Counterpart of ``artist_tpu/geometry/coordinates.py``. The WGS84 conversion
is host numpy in float64, as there: the geodetic linearization needs double
precision, and its result is float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.util import indices

# The WGS84 ellipsoid.
WGS84_A = 6378137.0
WGS84_B = 6356752.314245
WGS84_E2 = (WGS84_A**2 - WGS84_B**2) / WGS84_A**2


def convert_3d_points_to_4d_format(points: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1 to points ``[..., 3]``."""
    if points.shape[-1] != 3:
        raise ValueError(f"Expected 3D points but got points of shape {tuple(points.shape)}!")
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def convert_3d_directions_to_4d_format(directions: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 0 to directions ``[..., 3]``."""
    if directions.shape[-1] != 3:
        raise ValueError(f"Expected 3D directions but got directions of shape {tuple(directions.shape)}!")
    return torch.cat([directions, torch.zeros_like(directions[..., :1])], dim=-1)


def normalize_points(points: torch.Tensor) -> torch.Tensor:
    """Map each column of ``[N, D]`` points into the open interval (0, 1)."""
    point_range = points - torch.min(points, dim=0).values
    return (point_range + 1e-5) / torch.max(point_range + 2e-5, dim=0).values


def azimuth_elevation_to_enu(
    azimuth,
    elevation,
    slant_range: float = 1.0,
    degree: bool = True,
) -> torch.Tensor:
    """South-oriented azimuth and elevation to ENU coordinates ``[..., 3]``.

    Azimuth 0 points south and 90 degrees east: ``(r sin(az), -r cos(az),
    range sin(el))`` with ``r = range cos(el)``.
    Tensors keep their device; other inputs become CPU tensors.
    """
    azimuth = torch.as_tensor(azimuth, dtype=torch.float32)
    elevation = torch.as_tensor(elevation, dtype=torch.float32)
    if azimuth.shape != elevation.shape:
        raise ValueError("``azimuth`` and ``elevation`` must have identical shapes.")
    if degree:
        azimuth = torch.deg2rad(azimuth)
        elevation = torch.deg2rad(elevation)
    azimuth = torch.remainder(azimuth, 2 * math.pi)
    r = slant_range * torch.cos(elevation)
    return torch.stack(
        [r * torch.sin(azimuth), -r * torch.cos(azimuth), slant_range * torch.sin(elevation)], dim=-1
    )


def convert_wgs84_coordinates_to_local_enu(
    coordinates_to_transform: np.ndarray, reference_point: np.ndarray
) -> np.ndarray:
    """WGS84 (latitude, longitude, altitude) ``[N, 3]`` to local ENU offsets in
    meters from ``reference_point`` ``[3]``, float32 ``[N, 3]``.

    Host numpy in float64: the small-distance linearization around each
    point, with the ellipsoid's radii of curvature at its latitude.
    """
    coords = np.asarray(coordinates_to_transform, dtype=np.float64)
    ref = np.asarray(reference_point, dtype=np.float64)

    latitudes = np.deg2rad(coords[:, indices.latitude])
    longitudes = np.deg2rad(coords[:, indices.longitude])
    lat_ref = np.deg2rad(ref[indices.latitude])
    lon_ref = np.deg2rad(ref[indices.longitude])

    sin_lat = np.sin(latitudes)
    # Transverse (rn) and meridional (rm) radii of curvature.
    rn = WGS84_A / np.sqrt(1 - WGS84_E2 * sin_lat**2)
    rm = (WGS84_A * (1 - WGS84_E2)) / ((1 - WGS84_E2 * sin_lat**2) ** 1.5)

    out = np.zeros_like(coords, dtype=np.float64)
    out[:, indices.e] = -((lon_ref - longitudes) * rn * np.cos(latitudes))
    out[:, indices.n] = -((lat_ref - latitudes) * rm)
    out[:, indices.u] = coords[:, indices.altitude] - ref[indices.altitude]
    return out.astype(np.float32)


def bitmap_coordinates_to_target_coordinates(
    bitmap_coordinates: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    tower: SolarTower,
    target_area_indices: torch.Tensor,
) -> torch.Tensor:
    """Bitmap pixel coordinates ``[M, 2]`` (e, u) to homogeneous world coordinates ``[M, 4]``.

    A pixel is a cell centre (``(p + 0.5) / resolution``) and the e axis is
    flipped (the bitmap as seen from the field). ``bitmap_resolution`` is
    (width, height). Both the planar and the cylindrical mapping are computed
    and each sample takes the one of its global target index (planar areas
    first).
    """
    width, height = bitmap_resolution
    e_norm = (bitmap_coordinates[:, indices.unbatched_bitmap_e] + 0.5) / width
    u_norm = (bitmap_coordinates[:, indices.unbatched_bitmap_u] + 0.5) / height

    n_planar = tower.number_of_planar_target_areas
    planar_mask = (target_area_indices < n_planar)[:, None]
    coords3 = torch.zeros((target_area_indices.shape[0], 3), dtype=e_norm.dtype, device=e_norm.device)

    if n_planar > 0:
        p_idx = torch.clamp(target_area_indices, 0, n_planar - 1)
        dims = tower.planar_dimensions[p_idx]
        offsets = torch.stack(
            [
                (0.5 - e_norm) * dims[:, indices.target_dimensions_width],
                torch.zeros_like(e_norm),
                (0.5 - u_norm) * dims[:, indices.target_dimensions_height],
            ],
            dim=1,
        )
        coords3 = torch.where(planar_mask, tower.planar_centers[p_idx][:, :3] + offsets, coords3)

    n_cylindrical = tower.number_of_cylindrical_target_areas
    if n_cylindrical > 0:
        c_idx = torch.clamp(target_area_indices - n_planar, 0, n_cylindrical - 1)
        centers = tower.cylindrical_centers[c_idx][:, :3]
        axes = tower.cylindrical_axes[c_idx][:, :3]
        normals = tower.cylindrical_normals[c_idx][:, :3]
        radii = tower.cylindrical_radii[c_idx][:, None]
        theta = ((e_norm - 0.5) * tower.cylindrical_opening_angles[c_idx])[:, None]
        z = ((0.5 - u_norm) * tower.cylindrical_heights[c_idx])[:, None]
        cylindrical = (
            centers
            + radii * torch.cos(theta) * normals
            + radii * torch.sin(theta) * torch.linalg.cross(axes, normals, dim=-1)
            + z * axes
        )
        coords3 = torch.where(planar_mask, coords3, cylindrical)

    return convert_3d_points_to_4d_format(coords3)

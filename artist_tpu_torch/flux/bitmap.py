"""Flux bitmap post-processing (counterpart of ``artist_tpu/flux/bitmap.py``).

The trapezoid target distribution of the aim-point optimizer; the centre of
mass and the differentiable crop around it of the surface reconstructor.

The crop is an explicit bilinear resample with zero padding and
``align_corners=True`` semantics, as the JAX function writes it (floor, the
taps either side, zero outside), not ``F.grid_sample``, whose CUDA backward
scatters with atomics. The crop's sampling grid is an axis-aligned affine
map, so it is separable: the resample is two batched products with
per-map two-tap matrices, whose backward is deterministic. The matrices
hold the images' values, so the products need full fp32 precision
(TF32 off, PyTorch's default).
"""

from __future__ import annotations

import torch

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.util import constants, indices


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


def get_center_of_mass(bitmaps: torch.Tensor) -> torch.Tensor:
    """Centres of mass of flux bitmaps ``[M, height_u, width_e]`` in (e, u) pixel
    coordinates, ``[M, 2]``; about (0, 0) for an empty bitmap (the 1e-8 in the
    denominator)."""
    _, height_u, width_e = bitmaps.shape
    normalized = bitmaps / (bitmaps.sum(dim=(1, 2), keepdim=True) + 1e-8)
    e_coords = torch.linspace(0.0, width_e - 1, width_e, dtype=bitmaps.dtype, device=bitmaps.device)
    u_coords = torch.linspace(0.0, height_u - 1, height_u, dtype=bitmaps.dtype, device=bitmaps.device)
    e_center = torch.sum(normalized * e_coords[None, None, :], dim=(1, 2))
    u_center = torch.sum(normalized * u_coords[None, :, None], dim=(1, 2))
    return torch.stack([e_center, u_center], dim=1)


def _two_tap_matrix(grid: torch.Tensor, size: int) -> torch.Tensor:
    """``[M, K, size]`` weights of the bilinear taps of normalized coordinates
    ``grid`` ``[M, K]`` (-1 and 1 at the first and last pixel centres): ``1 - f``
    at ``floor(x)`` and ``f`` at ``floor(x) + 1``, nothing at a tap outside
    ``[0, size)``. The floor carries no gradient, the weights do."""
    x = (grid + 1.0) * (size - 1) / 2.0
    x0 = torch.floor(x)
    w1 = (x - x0)[..., None]
    pixels = torch.arange(size, dtype=x.dtype, device=x.device)
    at_x0 = (pixels == x0[..., None]).to(x.dtype)
    at_x1 = (pixels == x0[..., None] + 1.0).to(x.dtype)
    return (1.0 - w1) * at_x0 + w1 * at_x1


def _grid_sample_bilinear_zeros(
    images: torch.Tensor, grid_x: torch.Tensor, grid_y: torch.Tensor
) -> torch.Tensor:
    """Bilinear sampling with zero padding, ``align_corners=True`` semantics, on a
    separable grid: ``out[m, i, j]`` samples ``images[m]`` ``[M, H, W]`` at column
    ``grid_x[m, j]`` and row ``grid_y[m, i]`` (``[M, W_out]`` and ``[M, H_out]``,
    -1 and 1 the first and last pixel centres)."""
    _, height, width = images.shape
    columns = _two_tap_matrix(grid_x, width)  # [M, W_out, W]
    rows = _two_tap_matrix(grid_y, height)  # [M, H_out, H]
    return torch.bmm(rows, torch.bmm(images, columns.transpose(1, 2)))


def target_dimensions(tower: SolarTower, target_area_indices: torch.Tensor) -> torch.Tensor:
    """Physical (width, height) ``[M, 2]`` of the indexed target areas: a planar
    area's dimensions, a cylindrical one's arc length ``radius x opening
    angle`` and height."""
    n_planar = tower.number_of_planar_target_areas
    n_cylindrical = tower.number_of_cylindrical_target_areas
    planar_mask = (target_area_indices < n_planar)[:, None]
    dims = torch.zeros(
        (target_area_indices.shape[0], 2), dtype=torch.float32, device=target_area_indices.device
    )
    if n_planar > 0:
        p_idx = torch.clamp(target_area_indices, 0, n_planar - 1)
        dims = torch.where(planar_mask, tower.planar_dimensions[p_idx], dims)
    if n_cylindrical > 0:
        c_idx = torch.clamp(target_area_indices - n_planar, 0, n_cylindrical - 1)
        cylinder = torch.stack(
            [
                tower.cylindrical_radii[c_idx] * tower.cylindrical_opening_angles[c_idx],
                tower.cylindrical_heights[c_idx],
            ],
            dim=1,
        )
        dims = torch.where(planar_mask, dims, cylinder)
    return dims


def crop_flux_distributions_around_center(
    flux_distributions: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    crop_width: float = constants.utis_crop_width,
    crop_height: float = constants.utis_crop_height,
) -> torch.Tensor:
    """Differentiable crop of a physical window around each bitmap's centre of mass.

    Compares predictions with the UTIS-centred PAINT flux images: each
    ``[M, H, W]`` bitmap is resampled at its own resolution over a
    ``crop_width x crop_height`` m window (default 6 x 6) centred on its centre
    of mass, the target's physical size (:func:`target_dimensions`) giving the
    scale. Pixels of the window off the bitmap are 0.
    """
    _, height, width = flux_distributions.shape
    options = dict(dtype=flux_distributions.dtype, device=flux_distributions.device)
    normalized = flux_distributions / (flux_distributions.sum(dim=(1, 2), keepdim=True) + 1e-8)
    x_lin = torch.linspace(-1.0, 1.0, width, **options)
    y_lin = torch.linspace(-1.0, 1.0, height, **options)
    x_com = torch.sum(normalized * x_lin[None, None, :], dim=(1, 2))
    y_com = torch.sum(normalized * y_lin[None, :, None], dim=(1, 2))

    dims = target_dimensions(tower, target_area_indices)
    epsilon = 1e-8
    target_width = torch.clamp(dims[:, indices.target_dimensions_width], min=epsilon)
    target_height = torch.clamp(dims[:, indices.target_dimensions_height], min=epsilon)
    scale_x = crop_width / target_width
    scale_y = crop_height / target_height

    # The affine crop's grid in normalized coordinates: scale * base + centre.
    grid_x = scale_x[:, None] * x_lin[None, :] + x_com[:, None]
    grid_y = scale_y[:, None] * y_lin[None, :] + y_com[:, None]
    return _grid_sample_bilinear_zeros(flux_distributions, grid_x, grid_y)

"""Differentiable bilinear splatting of ray intensities onto flux bitmaps.

Counterpart of ``artist_tpu/raytracing/splatting.py``, following the JAX
package's Pallas methods on every device. The splat itself is
:class:`artist_tpu_torch.kernels.splat.BilinearSplat` (the CUDA kernels on
the card, the 4-tap ``index_add_`` scatter on the CPU); ``window`` takes the
lossy per-heliostat window around it (:func:`~artist_tpu_torch.kernels.splat.splat_windowed`),
``block_window`` the exact per-ray-block windows of
:mod:`artist_tpu_torch.kernels.splat_window`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from artist_tpu_torch.kernels.splat import splat, splat_windowed
from artist_tpu_torch.kernels.splat_window import splat_dynamic_window


@functools.lru_cache(maxsize=16)
def point_tile_order(
    points_u: int, points_v: int, facets: int, tile: int = 10
) -> tuple[int, ...]:
    """Static permutation ordering surface points by spatial tiles.

    Points are laid out row-major per facet; grouping them into
    ``tile x tile`` patches makes consecutive points spatially compact, so
    point-major ray blocks have compact bitmap deposit spans: the layout the
    dynamic-window splat wants.
    """
    order = []
    grid = np.arange(points_u * points_v).reshape(points_u, points_v)
    for facet in range(facets):
        for i in range(0, points_u, tile):
            for j in range(0, points_v, tile):
                order.append((facet * points_u * points_v + grid[i : i + tile, j : j + tile]).ravel())
    return tuple(np.concatenate(order).tolist())


def bilinear_splat(
    bitmap_coordinates_e: torch.Tensor,
    bitmap_coordinates_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    flip_up_down: bool = True,
    method: str = "scatter",
    window: int | None = None,
    block_window: int | None = None,
) -> torch.Tensor:
    """Splat ray intensities onto per-heliostat bitmaps.

    Each intersection deposits into its four neighbouring pixels with
    bilinear weights; rays whose 2x2 stencil leaves the bitmap are dropped.

    Parameters
    ----------
    bitmap_coordinates_e, bitmap_coordinates_u : torch.Tensor
        Continuous pixel coordinates ``[M, ...]`` (flattened per heliostat).
    intensities : torch.Tensor
        Ray intensities, same shape.
    bitmap_resolution : tuple[int, int]
        (width_e, height_u).
    flip_up_down : bool
        Flip the row axis so the image origin is bottom-left.
    method : str
        The JAX package's choice of TPU formulation. Accepted and ignored, as
        ``RenderConfig.splat_method`` is: the port computes one semantics, with its
        kernels on the card and their plain versions on the CPU.
    window : int | None
        Splat into a per-heliostat ``window``-pixel square at the
        intensity-weighted spot centre; rays outside it are dropped.
    block_window : int | None
        Exact per-ray-block row windows of this many rows (a multiple of 8);
        takes precedence over ``window``. Best with rays ordered point-major
        over spatially tiled surface points (:func:`point_tile_order`).

    Returns
    -------
    torch.Tensor
        Flux bitmaps ``[M, height_u, width_e]``.
    """
    num_heliostats = intensities.shape[0]
    e, u, w = (
        x.reshape(num_heliostats, -1).contiguous()
        for x in (bitmap_coordinates_e, bitmap_coordinates_u, intensities)
    )
    if block_window is not None:
        bitmaps = splat_dynamic_window(e, u, w, bitmap_resolution, int(block_window))
    elif window is not None:
        bitmaps = splat_windowed(e, u, w, bitmap_resolution, window)
    else:
        bitmaps = splat(e, u, w, bitmap_resolution)
    if flip_up_down:
        bitmaps = torch.flip(bitmaps, dims=(1,))
    return bitmaps

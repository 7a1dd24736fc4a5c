"""Differentiable bilinear splatting of ray intensities onto flux bitmaps.

Counterpart of ``artist_tpu/raytracing/splatting.py``. The splat itself is
:class:`artist_tpu_torch.kernels.splat.BilinearSplat`: the CUDA kernels on
the card, the 4-tap ``index_add_`` scatter (the JAX package's "scatter"
method) on the CPU.
"""

from __future__ import annotations

import torch

from artist_tpu_torch.kernels.splat import splat


def bilinear_splat(
    bitmap_coordinates_e: torch.Tensor,
    bitmap_coordinates_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    flip_up_down: bool = True,
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
    window, block_window : int | None
        The windowed and dynamic-window splats; not ported yet.

    Returns
    -------
    torch.Tensor
        Flux bitmaps ``[M, height_u, width_e]``.
    """
    if window is not None or block_window is not None:
        raise NotImplementedError(
            "the windowed and dynamic-window splats are not ported yet"
        )
    num_heliostats = intensities.shape[0]
    bitmaps = splat(
        bitmap_coordinates_e.reshape(num_heliostats, -1).contiguous(),
        bitmap_coordinates_u.reshape(num_heliostats, -1).contiguous(),
        intensities.reshape(num_heliostats, -1).contiguous(),
        bitmap_resolution,
    )
    if flip_up_down:
        bitmaps = torch.flip(bitmaps, dims=(1,))
    return bitmaps

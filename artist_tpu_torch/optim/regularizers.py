"""Control-point regularizers of the surface reconstructor.

Counterpart of ``artist_tpu/optim/regularizers.py``. Each takes the current
and the original control points ``[H, F, Cu, Cv, 3]`` and returns a loss per
surface: the facet mean, summed over ``reduction_dimensions`` (the facets).
"""

from __future__ import annotations

import torch


def smoothness_regularizer(
    current_control_points: torch.Tensor,
    original_control_points: torch.Tensor,
    reduction_dimensions: tuple[int, ...] = (1,),
) -> torch.Tensor:
    """Discrete Laplacian of the control-point displacements, edge-replicated:
    each displacement's deviation from the mean of its four grid neighbours."""
    delta = current_control_points - original_control_points
    # Edge-replicated padding of the (Cu, Cv) grid by concatenation, whose
    # backward is a deterministic sum of slices.
    padded = torch.cat([delta[:, :, :1], delta, delta[:, :, -1:]], dim=2)
    padded = torch.cat([padded[:, :, :, :1], padded, padded[:, :, :, -1:]], dim=3)
    laplace = (
        4 * delta
        - padded[:, :, :-2, 1:-1, :]
        - padded[:, :, 2:, 1:-1, :]
        - padded[:, :, 1:-1, :-2, :]
        - padded[:, :, 1:-1, 2:, :]
    )
    per_facet = torch.mean(laplace**2, dim=(2, 3, 4))
    return torch.sum(per_facet, dim=reduction_dimensions)


def ideal_surface_regularizer(
    current_control_points: torch.Tensor,
    original_control_points: torch.Tensor,
    reduction_dimensions: tuple[int, ...] = (1,),
) -> torch.Tensor:
    """Mean squared pull toward the original control points."""
    delta_squared = (current_control_points - original_control_points) ** 2
    per_facet = torch.mean(delta_squared, dim=(2, 3, 4))
    return torch.sum(per_facet, dim=reduction_dimensions)

"""NURBS grid and control-point helpers (counterpart of ``artist_tpu/nurbs/utils.py``)."""

from __future__ import annotations

import torch

from artist_tpu_torch.util import indices


def create_nurbs_evaluation_grid(
    number_of_evaluation_points: tuple[int, int],
    epsilon: float = 1e-7,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Cartesian grid of NURBS evaluation points in (eps, 1 - eps).

    Parameters
    ----------
    number_of_evaluation_points : tuple[int, int]
        Points in (e, n) direction.
    epsilon : float
        Endpoint offset guarding the parameter ends.
    device : torch.device | str
        Device of the result.

    Returns
    -------
    torch.Tensor
        Evaluation points ``[n_e * n_n, 2]``, e varying slowest
        (``torch.cartesian_prod`` order).
    """
    n_e, n_n = int(number_of_evaluation_points[0]), int(number_of_evaluation_points[1])
    pts_e = torch.linspace(epsilon, 1 - epsilon, n_e, dtype=torch.float32, device=device)
    pts_n = torch.linspace(epsilon, 1 - epsilon, n_n, dtype=torch.float32, device=device)
    return torch.cartesian_prod(pts_e, pts_n).reshape(n_e * n_n, 2)


def create_planar_nurbs_control_points(
    number_of_control_points: tuple[int, int], canting: torch.Tensor
) -> torch.Tensor:
    """Flat, equidistant control-point grids sized by the canting-vector norms.

    Parameters
    ----------
    number_of_control_points : tuple[int, int]
        Control points in (u, v) direction.
    canting : torch.Tensor
        Canting vectors per facet ``[..., F, 2, 4]``.

    Returns
    -------
    torch.Tensor
        Planar control points ``[..., F, n_u, n_v, 3]`` on ``canting``'s device.
    """
    n_u = int(number_of_control_points[indices.nurbs_u])
    n_v = int(number_of_control_points[indices.nurbs_v])

    u_lin = torch.linspace(0.0, 1.0, n_u, dtype=canting.dtype, device=canting.device)
    v_lin = torch.linspace(0.0, 1.0, n_v, dtype=canting.dtype, device=canting.device)

    facet_dimensions = torch.linalg.vector_norm(canting, dim=-1)  # [..., F, 2]
    half_e = facet_dimensions[..., indices.e]
    half_n = facet_dimensions[..., indices.n]

    u_coords = -half_e[..., None] + 2 * half_e[..., None] * u_lin  # [..., F, n_u]
    v_coords = -half_n[..., None] + 2 * half_n[..., None] * v_lin  # [..., F, n_v]

    batch = facet_dimensions.shape[:-1]
    out = torch.zeros(batch + (n_u, n_v, 3), dtype=canting.dtype, device=canting.device)
    out[..., indices.nurbs_u] = u_coords[..., :, None]
    out[..., indices.nurbs_v] = v_coords[..., None, :]
    return out

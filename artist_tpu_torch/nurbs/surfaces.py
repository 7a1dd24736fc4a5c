"""Batched differentiable NURBS surface evaluation.

Counterpart of ``artist_tpu/nurbs/surfaces.py``:

- **Analytic uniform knots**: clamped uniform knot vectors are never built;
  knot values come in closed form from indices
  (``clip((i - degree) / (C - degree), 0, 1)``).
- **Unrolled degree loops**: the Cox-de Boor recurrence (The NURBS Book
  A2.3) and its derivatives are unrolled over the small spline degree, so
  the batch sees only element-wise tensor ops.
- **One-hot contractions** scatter the (degree + 1) nonzero basis values onto
  the control grid, and a dense matmul against the stacked control points
  evaluates every surface at once.

All control points carry weight 1.
"""

from __future__ import annotations

import numpy as np
import torch

from artist_tpu_torch.geometry.transforms import (
    _normalize,
    canting_rotation_matrices,
    perform_canting,
)


def validate_uniform_knot_vectors(
    knot_vectors, degree: int, atol: float = 1e-6
) -> None:
    """Reject non-uniform knot vectors loudly.

    The analytic evaluation in this module assumes clamped UNIFORM knots.
    Any ingress path that receives explicit knot vectors must call this
    guard first: evaluating non-uniform knots with the uniform closed form
    would be silently wrong.

    Parameters
    ----------
    knot_vectors : array-like
        Knot vectors ``[..., C + degree + 1]`` (batched or flat).
    degree : int
        Spline degree.

    Raises
    ------
    ValueError
        If the knots are not clamped uniform within ``atol``.
    """
    knots = np.asarray(knot_vectors, dtype=np.float64)
    length = knots.shape[-1]
    number_of_control_points = length - degree - 1
    index = np.arange(length)
    expected = np.clip(
        (index - degree) / (number_of_control_points - degree), 0.0, 1.0
    )
    if not np.allclose(knots, expected, atol=atol):
        raise ValueError(
            "Non-uniform knot vectors are not supported: the NURBS evaluation "
            "uses the analytic clamped-uniform closed form. Re-parameterize "
            "the surface with uniform knots or refit the control points."
        )


def find_spans_uniform(
    evaluation_points: torch.Tensor, number_of_control_points: int, degree: int
) -> torch.Tensor:
    """Knot spans (int64) for clamped uniform knot vectors, O(1) closed form."""
    n_unique = number_of_control_points - degree + 1
    return torch.floor(evaluation_points * (n_unique - 1)).long() + degree


def _uniform_knot_value(
    index: torch.Tensor, number_of_control_points: int, degree: int
) -> torch.Tensor:
    """Analytic clamped uniform knot value at ``index``."""
    denom = number_of_control_points - degree
    return torch.clamp((index.to(torch.float32) - degree) / denom, 0.0, 1.0)


def basis_functions_and_derivatives(
    evaluation_points: torch.Tensor,
    spans: torch.Tensor,
    number_of_control_points: int,
    degree: int,
    nth_derivative: int = 1,
) -> list[list[torch.Tensor]]:
    """Nonzero B-spline basis functions and derivatives (A2.3, unrolled).

    Returns
    -------
    list[list[torch.Tensor]]
        ``derivatives[k][r]``: the k-th derivative of the r-th nonzero basis
        function, each with the batch shape of ``evaluation_points``.
    """
    t = evaluation_points
    ones = torch.ones_like(t)
    zeros = torch.zeros_like(t)

    def knot(i: torch.Tensor) -> torch.Tensor:
        return _uniform_knot_value(i, number_of_control_points, degree)

    ndu = [[zeros for _ in range(degree + 1)] for _ in range(degree + 1)]
    ndu[0][0] = ones
    left = [zeros for _ in range(degree + 1)]
    right = [zeros for _ in range(degree + 1)]

    for j in range(1, degree + 1):
        left[j] = t - knot(spans - j + 1)
        right[j] = knot(spans + j) - t
        saved = zeros
        for r in range(j):
            ndu[j][r] = right[r + 1] + left[j - r]
            tmp = ndu[r][j - 1] / ndu[j][r]
            ndu[r][j] = saved + right[r + 1] * tmp
            saved = left[j - r] * tmp
        ndu[j][j] = saved

    derivatives = [[zeros for _ in range(degree + 1)] for _ in range(nth_derivative + 1)]
    for j in range(degree + 1):
        derivatives[0][j] = ndu[j][degree]

    # a holds (alternating) the two most recent rows of the A2.3 recursion.
    a = [[zeros for _ in range(degree + 1)] for _ in range(2)]
    for r in range(degree + 1):
        s1, s2 = 0, 1
        a[0][0] = ones
        for k in range(1, nth_derivative + 1):
            d = zeros
            rk = r - k
            pk = degree - k
            if r >= k:
                a[s2][0] = a[s1][0] / ndu[pk + 1][rk]
                d = a[s2][0] * ndu[rk][pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if r - 1 <= pk else degree - r
            for j in range(j1, j2 + 1):
                a[s2][j] = (a[s1][j] - a[s1][j - 1]) / ndu[pk + 1][rk + j]
                d = d + a[s2][j] * ndu[rk + j][pk]
            if r <= pk:
                a[s2][k] = -a[s1][k - 1] / ndu[pk + 1][r]
                d = d + a[s2][k] * ndu[r][pk]
            derivatives[k][r] = d
            s1, s2 = s2, s1

    factor = degree
    for k in range(1, nth_derivative + 1):
        for j in range(degree + 1):
            derivatives[k][j] = derivatives[k][j] * factor
        factor *= degree - k

    return derivatives


def _basis_on_grid(
    evaluation_points: torch.Tensor, number_of_control_points: int, degree: int
) -> torch.Tensor:
    """Values and first derivatives of all basis functions on the full control axis.

    ``[..., 2, C]``: the (degree + 1) nonzero values scattered by a one-hot
    contraction onto the C control points of one direction.
    """
    spans = find_spans_uniform(evaluation_points, number_of_control_points, degree)
    basis = basis_functions_and_derivatives(
        evaluation_points, spans, number_of_control_points, degree, 1
    )
    stacked = torch.stack(
        [torch.stack(basis[k], dim=-1) for k in range(2)], dim=-2
    )  # [..., 2, degree + 1]
    window = (spans - degree)[..., None] + torch.arange(
        degree + 1, device=spans.device
    )
    onehot = (
        window[..., None] == torch.arange(number_of_control_points, device=spans.device)
    ).to(stacked.dtype)  # [..., degree + 1, C]
    return torch.matmul(stacked, onehot)


def _evaluate_shared_grid(
    control_points: torch.Tensor,
    degrees: tuple[int, int],
    evaluation_points: torch.Tensor,
    canting: torch.Tensor | None,
    facet_translations: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluation for one grid shared by all (surface, facet) pairs.

    The joint basis ``[P, Cu * Cv]`` is shared, so each derivative order is
    ONE ``[4 S F, Cu Cv] @ [Cu Cv, P]`` matmul against the stacked control
    points.
    """
    degree_u, degree_v = degrees
    num_s, num_f, num_cu, num_cv, _ = control_points.shape
    num_p = evaluation_points.shape[0]

    bu_full = _basis_on_grid(evaluation_points[:, 0], num_cu, degree_u)  # [P, 2, Cu]
    bv_full = _basis_on_grid(evaluation_points[:, 1], num_cv, degree_v)  # [P, 2, Cv]

    cp_h = torch.cat([control_points, torch.ones_like(control_points[..., :1])], dim=-1)
    cp2t = (
        cp_h.reshape(num_s * num_f, num_cu * num_cv, 4)
        .permute(2, 0, 1)
        .reshape(4 * num_s * num_f, num_cu * num_cv)
    )

    def derivative_surface(k: int, l: int) -> list[torch.Tensor]:
        joint = (bu_full[:, k, :, None] * bv_full[:, l, None, :]).reshape(
            num_p, num_cu * num_cv
        )
        rows = (cp2t @ joint.T).reshape(4, num_s, num_f, num_p)
        return [rows[c] for c in range(4)]  # 4 x [S, F, P]

    value = derivative_surface(0, 0)
    du = derivative_surface(1, 0)[:3]
    dv = derivative_surface(0, 1)[:3]
    inv_weights = 1.0 / value[3]
    point = [value[c] * inv_weights for c in range(3)]

    # normals = normalize(cross(du, dv)), component-wise.
    cross = [
        du[1] * dv[2] - du[2] * dv[1],
        du[2] * dv[0] - du[0] * dv[2],
        du[0] * dv[1] - du[1] * dv[0],
    ]
    norm = torch.clamp(
        torch.sqrt(cross[0] ** 2 + cross[1] ** 2 + cross[2] ** 2), min=1e-12
    )
    normal = [c / norm for c in cross]

    if canting is not None:
        # Row-vector forward canting (data @ R^T), component-wise:
        # out_c = sum_j data_j * R[c, j] with R per (surface, facet).
        rotation = canting_rotation_matrices(canting)[..., :3, :3]  # [S, F, 3, 3]

        def cant(vector: list[torch.Tensor]) -> list[torch.Tensor]:
            return [
                vector[0] * rotation[:, :, c, 0, None]
                + vector[1] * rotation[:, :, c, 1, None]
                + vector[2] * rotation[:, :, c, 2, None]
                for c in range(3)
            ]

        point = cant(point)
        point = [point[c] + facet_translations[:, :, c, None] for c in range(3)]
        normal = cant(normal)

    points4 = torch.stack(point + [torch.ones_like(point[0])], dim=-1)
    normals4 = torch.stack(normal + [torch.zeros_like(normal[0])], dim=-1)
    return points4, normals4


def evaluate_nurbs_surfaces(
    control_points: torch.Tensor,
    degrees: tuple[int, int],
    evaluation_points: torch.Tensor,
    canting: torch.Tensor | None = None,
    facet_translations: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Surface points and normals of batched NURBS surfaces (A3.6).

    Parameters
    ----------
    control_points : torch.Tensor
        ``[S, F, Cu, Cv, 3]``.
    degrees : tuple[int, int]
        Spline degrees (u, v).
    evaluation_points : torch.Tensor
        ``[S, F, P, 2]``, or ``[P, 2]`` shared by all surfaces.
    canting : torch.Tensor | None
        Canting vectors ``[S, F, 2, 4]``; if given, points and normals are
        canted and translated into the heliostat frame.
    facet_translations : torch.Tensor | None
        Facet translations ``[S, F, 4]``.

    Returns
    -------
    tuple of torch.Tensor
        Homogeneous surface points and unit normals, each ``[S, F, P, 4]``.
    """
    degree_u, degree_v = int(degrees[0]), int(degrees[1])
    num_cu, num_cv = control_points.shape[2], control_points.shape[3]

    if evaluation_points.dim() == 2:
        return _evaluate_shared_grid(
            control_points,
            (degree_u, degree_v),
            evaluation_points,
            canting,
            facet_translations,
        )

    bu_full = _basis_on_grid(evaluation_points[..., 0], num_cu, degree_u)  # [S,F,P,2,Cu]
    bv_full = _basis_on_grid(evaluation_points[..., 1], num_cv, degree_v)  # [S,F,P,2,Cv]
    cp_h = torch.cat([control_points, torch.ones_like(control_points[..., :1])], dim=-1)
    temp = torch.einsum("sfplj,sfijc->sfplic", bv_full, cp_h)
    skl = torch.einsum("sfpki,sfplic->sfpklc", bu_full, temp)  # [S, F, P, k, l, 4]

    surface_points = skl[..., 0, 0, :]
    derivative_u = skl[..., 1, 0, :]
    derivative_v = skl[..., 0, 1, :]
    points3 = surface_points[..., :3] / surface_points[..., 3:4]
    normals3 = _normalize(
        torch.linalg.cross(derivative_u[..., :3], derivative_v[..., :3], dim=-1)
    )
    points4 = torch.cat([points3, torch.ones_like(points3[..., :1])], dim=-1)
    normals4 = torch.cat([normals3, torch.zeros_like(normals3[..., :1])], dim=-1)
    if canting is not None:
        points4 = perform_canting(canting, points4) + facet_translations[:, :, None, :]
        normals4 = perform_canting(canting, normals4)
    return points4, normals4

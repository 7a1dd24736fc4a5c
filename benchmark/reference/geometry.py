"""Heliostat geometry in plain PyTorch: NURBS facets, linear actuators, rigid-body kinematics.

East-north-up frame, homogeneous 4-vectors, 4 x 4 matrices acting on column
vectors. The conventions are ARTIST's: a heliostat's kinematic reference normal
points south, its sampled surface faces up, and one quarter turn about east
takes the one to the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SOUTH = (0.0, -1.0, 0.0, 0.0)
ORIGIN = (0.0, 0.0, 0.0, 1.0)


def _matrix(rows: list[list[torch.Tensor]]) -> torch.Tensor:
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def rotation_e(angle: torch.Tensor) -> torch.Tensor:
    c, s, one, zero = torch.cos(angle), torch.sin(angle), torch.ones_like(angle), torch.zeros_like(angle)
    return _matrix([[one, zero, zero, zero], [zero, c, -s, zero], [zero, s, c, zero], [zero, zero, zero, one]])


def rotation_n(angle: torch.Tensor) -> torch.Tensor:
    c, s, one, zero = torch.cos(angle), torch.sin(angle), torch.ones_like(angle), torch.zeros_like(angle)
    return _matrix([[c, zero, -s, zero], [zero, one, zero, zero], [s, zero, c, zero], [zero, zero, zero, one]])


def rotation_u(angle: torch.Tensor) -> torch.Tensor:
    c, s, one, zero = torch.cos(angle), torch.sin(angle), torch.ones_like(angle), torch.zeros_like(angle)
    return _matrix([[c, -s, zero, zero], [s, c, zero, zero], [zero, zero, one, zero], [zero, zero, zero, one]])


def translation(e: torch.Tensor, n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    one, zero = torch.ones_like(e), torch.zeros_like(e)
    return _matrix([[one, zero, zero, e], [zero, one, zero, n], [zero, zero, one, u], [zero, zero, zero, one]])


def chain(*matrices: torch.Tensor) -> torch.Tensor:
    out = matrices[0]
    for matrix in matrices[1:]:
        out = out @ matrix
    return out


def unit(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


# ---------------------------------------------------------------------------
# Linear (lead-screw) actuators. Packed rows as in ARTIST's scenario files:
# static [type, clockwise, min, max, increment, offset, pivot radius] x 2 axes,
# optimizable [initial angle, initial stroke length] x 2 axes.
# ---------------------------------------------------------------------------

ACTUATOR_EPSILON = 1e-6


def _positive(x: torch.Tensor) -> torch.Tensor:
    """ARTIST's physics-informed parameters: softplus with beta 100, plus a floor."""
    return F.softplus(x, beta=100.0, threshold=20.0) + ACTUATOR_EPSILON


def _actuator_terms(static: torch.Tensor, optimizable: torch.Tensor):
    increment, offset, pivot = _positive(static[:, 4]), _positive(static[:, 5]), _positive(static[:, 6])
    initial_angle, initial_stroke = optimizable[:, 0], _positive(optimizable[:, 1])
    clockwise = static[:, 1] == 1
    return increment, offset, pivot, initial_angle, initial_stroke, clockwise


def _stroke_angle(stroke, offset, pivot):
    """The law of cosines: stroke length -> the angle at the pivot."""
    stroke = torch.clamp(stroke, torch.abs(offset - pivot) + ACTUATOR_EPSILON, offset + pivot - ACTUATOR_EPSILON)
    cosine = (offset**2 + pivot**2 - stroke**2) / (2.0 * offset * pivot)
    return torch.arccos(torch.clamp(cosine, -1.0 + 1e-6, 1.0 - 1e-6))


def motor_to_angles(static: torch.Tensor, optimizable: torch.Tensor, motors: torch.Tensor) -> torch.Tensor:
    """Joint angles ``[M, 2]`` of motor positions ``[M, 2]``."""
    increment, offset, pivot, initial_angle, initial_stroke, clockwise = _actuator_terms(static, optimizable)
    absolute = _stroke_angle(motors / increment + initial_stroke, offset, pivot)
    absolute_at_zero = _stroke_angle(initial_stroke, offset, pivot)
    change = absolute_at_zero - absolute
    return initial_angle + torch.where(clockwise, change, -change)


def angles_to_motor(static: torch.Tensor, optimizable: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Motor positions ``[M, 2]`` of joint angles ``[M, 2]``."""
    increment, offset, pivot, initial_angle, initial_stroke, clockwise = _actuator_terms(static, optimizable)
    change = torch.where(clockwise, angles - initial_angle, initial_angle - angles)
    pivot_angle = _stroke_angle(initial_stroke, offset, pivot) - change
    cosine = torch.clamp(torch.cos(pivot_angle), -1.0 + 1e-6, 1.0 - 1e-6)
    stroke = torch.sqrt(offset**2 + pivot**2 - 2.0 * offset * pivot * cosine)
    stroke = torch.clamp(stroke, torch.abs(offset - pivot) + ACTUATOR_EPSILON, offset + pivot - ACTUATOR_EPSILON)
    return (stroke - initial_stroke) * increment


# ---------------------------------------------------------------------------
# Rigid-body kinematics with two joints (ARTIST's "rigid body" model).
# Rotation deviations per heliostat: [first joint tilt n, first joint tilt u,
# second joint tilt e, second joint tilt n]; translation deviations are 0.
# ---------------------------------------------------------------------------


def surface_to_south(device) -> torch.Tensor:
    """The quarter turn about east that takes the upward sampled surface to south."""
    return rotation_e(torch.tensor(math.pi / 2, dtype=torch.float32, device=device))


def forward_kinematics(positions, deviations, static, optimizable, motors) -> torch.Tensor:
    """Orientations ``[M, 4, 4]`` (surface frame to world) of motor positions ``[M, 2]``."""
    angles = motor_to_angles(static, optimizable, motors)
    zero = torch.zeros_like(angles[:, 0])
    joint_1 = chain(
        rotation_n(deviations[:, 0]), rotation_u(deviations[:, 1]), translation(zero, zero, zero),
        rotation_e(angles[:, 0]),
    )
    joint_2 = chain(
        rotation_e(deviations[:, 2]), rotation_n(deviations[:, 3]), translation(zero, zero, zero),
        rotation_u(angles[:, 1]),
    )
    place = translation(positions[:, 0], positions[:, 1], positions[:, 2])
    return chain(place, joint_1, joint_2, translation(zero, zero, zero))


def inverse_kinematics(normals, deviations, static, optimizable) -> tuple[torch.Tensor, torch.Tensor]:
    """Motor positions ``[M, 2]`` that turn the kinematic reference normal into
    ``normals`` ``[M, 4]``, and whether either of the two solutions lies in the
    motor range. The first solution is taken where it lies in range."""
    first = chain(rotation_n(deviations[:, 0]), rotation_u(deviations[:, 1]))
    second = chain(rotation_e(deviations[:, 2]), rotation_n(deviations[:, 3]))
    local = (first.transpose(-1, -2) @ normals[..., None])[..., 0]
    a, b = second[:, 0, 0], second[:, 0, 1]
    phase = torch.arctan2(-b, a)
    ratio = torch.clamp(local[:, 0] / (torch.sqrt(a**2 + b**2) + 1e-8), -1.0 + 1e-8, 1.0 - 1e-8)
    south = torch.tensor(SOUTH, device=normals.device)

    def wrap(angle):
        return torch.arctan2(torch.sin(angle), torch.cos(angle))

    solutions = []
    for theta_2 in (wrap(torch.arcsin(ratio) - phase), wrap(math.pi - torch.arcsin(ratio) - phase)):
        v = (chain(second, rotation_u(theta_2)) @ south)
        theta_1 = wrap(torch.arctan2(
            v[:, 1] * local[:, 2] - v[:, 2] * local[:, 1], v[:, 1] * local[:, 1] + v[:, 2] * local[:, 2]
        ))
        solutions.append(angles_to_motor(static, optimizable, torch.stack([theta_1, theta_2], dim=-1)))
    low, high = static[:, 2], static[:, 3]
    in_range = [torch.all((m >= low) & (m <= high), dim=1) for m in solutions]
    return torch.where(in_range[0][:, None], solutions[0], solutions[1]), in_range[0] | in_range[1]


def align_to_aim_points(positions, deviations, static, optimizable, incident, aim_points,
                        iterations: int = 4, tolerance: float = 1e-4):
    """ARTIST's aim-point alignment: alternate forward and inverse kinematics from
    motor positions 0 until the normals' change is within ``tolerance`` for every
    heliostat, at most ``iterations`` times. Returns (orientations ``[M, 4, 4]``,
    surface frame included, motor positions ``[M, 2]``)."""
    device = incident.device
    south = torch.tensor(SOUTH, device=device)
    origin = torch.tensor(ORIGIN, device=device)
    motors = torch.zeros((incident.shape[0], 2), device=device)
    converged = torch.zeros((), dtype=torch.bool, device=device)
    previous = None
    orientation = None
    for _ in range(iterations):
        orientation = forward_kinematics(positions, deviations, static, optimizable, motors)
        normal = orientation @ south
        reflection = unit(aim_points[:, :3] - (orientation @ origin)[:, :3], eps=1e-8)
        wanted = unit(reflection - incident[:, :3], eps=1e-8)
        wanted = torch.cat([wanted, torch.zeros_like(wanted[:, :1])], dim=-1)
        residual = torch.abs(wanted - normal).mean(dim=-1)
        if previous is not None:
            converged = converged | torch.all(torch.abs(previous - residual) <= tolerance)
        previous = residual
        update, _ = inverse_kinematics(wanted, deviations, static, optimizable)
        motors = torch.where(converged, motors, update)
    return orientation @ surface_to_south(device), motors


def motor_orientations(positions, deviations, static, optimizable, motors) -> torch.Tensor:
    """Orientations ``[M, 4, 4]``, surface frame included, at motor positions ``[M, 2]``."""
    return forward_kinematics(positions, deviations, static, optimizable, motors) @ surface_to_south(motors.device)


# ---------------------------------------------------------------------------
# NURBS facets: clamped uniform knots, unit weights, Cox-de Boor.
# ---------------------------------------------------------------------------


def bspline_basis(x: torch.Tensor, count: int, degree: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Values and first derivatives ``[P, count]`` of the ``count`` B-splines of
    ``degree`` on a clamped uniform knot vector, at parameters ``x`` ``[P]`` in (0, 1)."""
    index = torch.arange(count + degree + 1, dtype=torch.float32, device=x.device)
    knots = torch.clamp((index - degree) / (count - degree), 0.0, 1.0)
    t = x[:, None]
    basis = ((knots[:-1] <= t) & (t < knots[1:])).to(torch.float32)  # degree 0
    for p in range(1, degree + 1):
        left_span = knots[p:-1] - knots[: -p - 1]
        right_span = knots[p + 1 :] - knots[1:-p]
        left = torch.where(left_span > 0, (t - knots[: -p - 1]) / torch.where(left_span > 0, left_span, 1.0), 0.0)
        right = torch.where(right_span > 0, (knots[p + 1 :] - t) / torch.where(right_span > 0, right_span, 1.0), 0.0)
        if p == degree:
            # d/dx N_{i,p} = p (N_{i,p-1} / span_i - N_{i+1,p-1} / span_{i+1})
            a = torch.where(left_span > 0, degree / torch.where(left_span > 0, left_span, 1.0), 0.0)
            b = torch.where(right_span > 0, degree / torch.where(right_span > 0, right_span, 1.0), 0.0)
            derivative = a * basis[:, :-1] - b * basis[:, 1:]
        basis = left * basis[:, :-1] + right * basis[:, 1:]
    return basis, derivative


def evaluation_grid(points_e: int, points_n: int, device, epsilon: float = 1e-7) -> torch.Tensor:
    """Surface parameters ``[points_e * points_n, 2]`` in (epsilon, 1 - epsilon), e slowest."""
    e = torch.linspace(epsilon, 1 - epsilon, points_e, device=device)
    n = torch.linspace(epsilon, 1 - epsilon, points_n, device=device)
    return torch.stack(torch.meshgrid(e, n, indexing="ij"), dim=-1).reshape(-1, 2)


def canting_rotations(canting: torch.Tensor) -> torch.Tensor:
    """Rotations ``[..., 3, 3]`` whose columns are each facet's e, n and u axes."""
    e = unit(canting[..., 0, :3])
    u = unit(torch.linalg.cross(e, canting[..., 1, :3], dim=-1), eps=1e-8)
    n = unit(torch.linalg.cross(u, e, dim=-1), eps=1e-8)
    return torch.stack([e, n, u], dim=-1)


def nurbs_surfaces(control_points: torch.Tensor, canting: torch.Tensor, translations: torch.Tensor,
                   grid: torch.Tensor, degree: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Points and unit normals ``[S, F * P, 4]`` of surfaces with control points
    ``[S, F, Cu, Cv, 3]``, canted (``[S, F, 2, 4]``) and translated (``[S, F, 4]``)
    into the heliostat frame; the facets one after another."""
    surfaces, facets, count_u, count_v, _ = control_points.shape
    value_u, slope_u = bspline_basis(grid[:, 0], count_u, degree)
    value_v, slope_v = bspline_basis(grid[:, 1], count_v, degree)

    def tensor_product(bu, bv):
        joint = (bu[:, :, None] * bv[:, None, :]).reshape(grid.shape[0], count_u * count_v)
        return joint @ control_points.reshape(surfaces * facets, count_u * count_v, 3)  # [S F, P, 3]

    weight = (value_u.sum(dim=1) * value_v.sum(dim=1))[:, None]
    points = tensor_product(value_u, value_v) / weight
    normals = unit(torch.linalg.cross(tensor_product(slope_u, value_v), tensor_product(value_u, slope_v), dim=-1))
    rotation = canting_rotations(canting).reshape(surfaces * facets, 3, 3)
    points = points @ rotation.transpose(-1, -2) + translations.reshape(surfaces * facets, 1, 4)[..., :3]
    normals = normals @ rotation.transpose(-1, -2)
    points = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    normals = torch.cat([normals, torch.zeros_like(normals[..., :1])], dim=-1)
    return points.reshape(surfaces, -1, 4), normals.reshape(surfaces, -1, 4)


def orient(points: torch.Tensor, normals: torch.Tensor, orientations: torch.Tensor):
    """Surfaces ``[M, P, 4]`` into the world by orientations ``[M, 4, 4]``."""
    transposed = orientations.transpose(-1, -2)
    return points @ transposed, normals @ transposed

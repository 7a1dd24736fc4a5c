"""Rigid-body two-joint heliostat kinematics, pure functions.

Counterpart of ``artist_tpu/field/kinematics_rigid_body.py``. The aim-point
fixed-point iteration runs its maximum number of iterations with a global
``done`` tensor that freezes the motor update once converged, instead of a
Python ``break`` on a host value: the loop never waits for the device.

Conventions: the kinematics reference orientation is south (0, -1, 0, 0) in
ENU; sampled surfaces face up (0, 0, 1, 0), compensated by a constant
initial-orientation offset rotation.
"""

from __future__ import annotations

import logging

import torch

from artist_tpu_torch.field import actuators
from artist_tpu_torch.geometry import transforms
from artist_tpu_torch.geometry.rotations import decompose_rotations
from artist_tpu_torch.geometry.transforms import _normalize
from artist_tpu_torch.util import indices

log = logging.getLogger("artist_tpu_torch.field")

KINEMATICS_STANDARD_ORIENTATION = (0.0, -1.0, 0.0, 0.0)
HOMOGENEOUS_ORIGIN = (0.0, 0.0, 0.0, 1.0)


def _mm(*mats: torch.Tensor) -> torch.Tensor:
    """Chain batched 4x4 matmuls."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.matmul(out, m)
    return out


def initial_orientation_offset(device: torch.device | str = "cpu") -> torch.Tensor:
    """Rotation ``[1, 4, 4]`` from the flat sampled-surface frame (+U) to south.

    Computed by axis-angle decomposition; evaluates to ``rotate_e(pi/2)``.
    """
    sampled = torch.tensor([[0.0, 0.0, 1.0, 0.0]], dtype=torch.float32, device=device)
    standard = torch.tensor(KINEMATICS_STANDARD_ORIENTATION, device=device)
    east, north, up = decompose_rotations(sampled, standard)
    return _mm(transforms.rotate_e(east), transforms.rotate_n(north), transforms.rotate_u(up))


def orientations_from_motor_positions(
    motor_positions: torch.Tensor,
    heliostat_positions: torch.Tensor,
    translation_deviations: torch.Tensor,
    rotation_deviations: torch.Tensor,
    actuator_type: str,
    actuator_non_optimizable: torch.Tensor,
    actuator_optimizable: torch.Tensor,
) -> torch.Tensor:
    """Forward kinematics: motor positions ``[M, 2]`` -> orientations ``[M, 4, 4]``.

    translate(position) @ J1 @ J2 @ translate(concentrator deviation), where
    J1 = R_n(tilt) R_u(tilt) T(dev) R_e(theta1) and
    J2 = R_e(tilt) R_n(tilt) T(dev) R_u(theta2). No initial offset.
    """
    joint_angles = actuators.motor_positions_to_angles(
        actuator_type, actuator_non_optimizable, actuator_optimizable, motor_positions
    )

    position_translation = transforms.translate_enu(
        e=heliostat_positions[:, indices.e],
        n=heliostat_positions[:, indices.n],
        u=heliostat_positions[:, indices.u],
    )
    joint_1 = _mm(
        transforms.rotate_n(rotation_deviations[:, indices.first_joint_tilt_n]),
        transforms.rotate_u(rotation_deviations[:, indices.first_joint_tilt_u]),
        transforms.translate_enu(
            e=translation_deviations[:, indices.first_joint_translation_e],
            n=translation_deviations[:, indices.first_joint_translation_n],
            u=translation_deviations[:, indices.first_joint_translation_u],
        ),
        transforms.rotate_e(joint_angles[:, indices.joint_angles_e]),
    )
    joint_2 = _mm(
        transforms.rotate_e(rotation_deviations[:, indices.second_joint_tilt_e]),
        transforms.rotate_n(rotation_deviations[:, indices.second_joint_tilt_n]),
        transforms.translate_enu(
            e=translation_deviations[:, indices.second_joint_translation_e],
            n=translation_deviations[:, indices.second_joint_translation_n],
            u=translation_deviations[:, indices.second_joint_translation_u],
        ),
        transforms.rotate_u(joint_angles[:, indices.joint_angles_u]),
    )
    concentrator_translation = transforms.translate_enu(
        e=translation_deviations[:, indices.concentrator_translation_e],
        n=translation_deviations[:, indices.concentrator_translation_n],
        u=translation_deviations[:, indices.concentrator_translation_u],
    )
    return _mm(position_translation, joint_1, joint_2, concentrator_translation)


def motor_positions_from_normals(
    normals: torch.Tensor,
    rotation_deviations: torch.Tensor,
    actuator_type: str,
    actuator_non_optimizable: torch.Tensor,
    actuator_optimizable: torch.Tensor,
    epsilon: float = 1e-8,
    return_validity: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Inverse kinematics: desired concentrator normals ``[M, 4]`` -> motor positions.

    Closed-form two-solution phase-shifted-sinusoid solve for (theta1,
    theta2) after factoring out the joint rotation deviations. Solution 1 is
    taken where its motor positions lie inside the actuator limits, solution
    2 otherwise (also when neither is valid).

    Returns
    -------
    torch.Tensor or tuple of torch.Tensor
        Motor positions ``[M, 2]``; with ``return_validity``, also a validity
        mask ``[M]`` that is False where NEITHER solution lies inside the motor
        limits.
    """
    first_dev = _mm(
        transforms.rotate_n(rotation_deviations[:, indices.first_joint_tilt_n]),
        transforms.rotate_u(rotation_deviations[:, indices.first_joint_tilt_u]),
    )
    second_dev = _mm(
        transforms.rotate_e(rotation_deviations[:, indices.second_joint_tilt_e]),
        transforms.rotate_n(rotation_deviations[:, indices.second_joint_tilt_n]),
    )

    # n' = F1^T n: remove the first-joint rotation deviations.
    normal_after_first = torch.einsum("mji,mj->mi", first_dev, normals)

    # n'_e = A sin(theta2) + B cos(theta2) with A = F2_00, B = -F2_01.
    f2_00 = second_dev[:, indices.e, indices.e]
    f2_01 = second_dev[:, indices.e, indices.n]
    denominator = torch.sqrt(f2_00**2 + f2_01**2)
    phi = torch.arctan2(-f2_01, f2_00)
    ratio = torch.clamp(
        normal_after_first[:, indices.e] / (denominator + epsilon),
        -1.0 + epsilon,
        1.0 - epsilon,
    )
    theta2_1 = torch.arcsin(ratio) - phi
    theta2_2 = torch.pi - torch.arcsin(ratio) - phi
    # Wrap into [-pi, pi].
    theta2_1 = torch.arctan2(torch.sin(theta2_1), torch.cos(theta2_1))
    theta2_2 = torch.arctan2(torch.sin(theta2_2), torch.cos(theta2_2))

    standard = torch.tensor(KINEMATICS_STANDARD_ORIENTATION, device=normals.device)

    def theta1_for(theta2: torch.Tensor) -> torch.Tensor:
        v = _mm(second_dev, transforms.rotate_u(theta2)) @ standard
        theta1 = torch.arctan2(
            v[:, indices.n] * normal_after_first[:, indices.u]
            - v[:, indices.u] * normal_after_first[:, indices.n],
            v[:, indices.n] * normal_after_first[:, indices.n]
            + v[:, indices.u] * normal_after_first[:, indices.u],
        )
        return torch.arctan2(torch.sin(theta1), torch.cos(theta1))

    motor_1 = actuators.angles_to_motor_positions(
        actuator_type,
        actuator_non_optimizable,
        actuator_optimizable,
        torch.stack([theta1_for(theta2_1), theta2_1], dim=-1),
    )
    motor_2 = actuators.angles_to_motor_positions(
        actuator_type,
        actuator_non_optimizable,
        actuator_optimizable,
        torch.stack([theta1_for(theta2_2), theta2_2], dim=-1),
    )

    min_pos = actuator_non_optimizable[:, indices.actuator_min_motor_position]
    max_pos = actuator_non_optimizable[:, indices.actuator_max_motor_position]
    solution_1_valid = torch.all((motor_1 >= min_pos) & (motor_1 <= max_pos), dim=1)
    motor_positions = torch.where(solution_1_valid[:, None], motor_1, motor_2)
    if not return_validity:
        return motor_positions
    solution_2_valid = torch.all((motor_2 >= min_pos) & (motor_2 <= max_pos), dim=1)
    return motor_positions, solution_1_valid | solution_2_valid


def motor_positions_to_orientations(
    motor_positions: torch.Tensor,
    heliostat_positions: torch.Tensor,
    translation_deviations: torch.Tensor,
    rotation_deviations: torch.Tensor,
    actuator_type: str,
    actuator_non_optimizable: torch.Tensor,
    actuator_optimizable: torch.Tensor,
) -> torch.Tensor:
    """Orientations ``[M, 4, 4]`` including the initial-orientation offset."""
    orientations = orientations_from_motor_positions(
        motor_positions,
        heliostat_positions,
        translation_deviations,
        rotation_deviations,
        actuator_type,
        actuator_non_optimizable,
        actuator_optimizable,
    )
    return _mm(orientations, initial_orientation_offset(motor_positions.device))


def incident_ray_directions_to_orientations(
    incident_ray_directions: torch.Tensor,
    aim_points: torch.Tensor,
    heliostat_positions: torch.Tensor,
    translation_deviations: torch.Tensor,
    rotation_deviations: torch.Tensor,
    actuator_type: str,
    actuator_non_optimizable: torch.Tensor,
    actuator_optimizable: torch.Tensor,
    max_num_iterations: int = 4,
    min_eps: float = 0.0001,
    warn_invalid: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Aim-point alignment: fixed-point iteration of forward/inverse kinematics.

    A global ``done`` tensor freezes the motor update once the normal
    residual changes by at most ``min_eps`` for every heliostat, which equals
    an early ``break``.

    ``warn_invalid`` logs the heliostats for which, in any iteration,
    neither motor solution respects the limits. The validity masks are
    AND-ed on the device and read on the host ONCE per call, after the loop;
    pass False to keep the call free of any host sync.

    Returns
    -------
    tuple of torch.Tensor
        Orientation matrices ``[M, 4, 4]`` (offset applied) and the final
        motor positions ``[M, 2]``.
    """
    num_active = incident_ray_directions.shape[0]
    device = incident_ray_directions.device
    standard = torch.tensor(KINEMATICS_STANDARD_ORIENTATION, device=device)
    origin = torch.tensor(HOMOGENEOUS_ORIGIN, device=device)
    motor_positions = torch.zeros((num_active, 2), dtype=torch.float32, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    all_valid = torch.ones((num_active,), dtype=torch.bool, device=device)
    last_loss = None
    orientations = None

    for _ in range(max_num_iterations):
        orientations = orientations_from_motor_positions(
            motor_positions,
            heliostat_positions,
            translation_deviations,
            rotation_deviations,
            actuator_type,
            actuator_non_optimizable,
            actuator_optimizable,
        )
        concentrator_normals = orientations @ standard
        concentrator_origins = orientations @ origin

        desired_reflection = _normalize(
            aim_points[:, :3] - concentrator_origins[:, :3], eps=1e-8
        )
        desired_normals3 = _normalize(
            -incident_ray_directions[:, :3] + desired_reflection, eps=1e-8
        )
        desired_normals = torch.cat(
            [desired_normals3, torch.zeros_like(desired_normals3[:, :1])], dim=-1
        )
        loss = torch.abs(desired_normals - concentrator_normals).mean(dim=-1)

        if last_loss is not None:
            done = done | torch.all(torch.abs(last_loss - loss) <= min_eps)
        last_loss = loss

        new_motor, motor_valid = motor_positions_from_normals(
            desired_normals,
            rotation_deviations,
            actuator_type,
            actuator_non_optimizable,
            actuator_optimizable,
            return_validity=True,
        )
        all_valid = all_valid & motor_valid
        motor_positions = torch.where(done, motor_positions, new_motor)

    if warn_invalid:
        invalid = torch.nonzero(~all_valid).flatten().tolist()
        if invalid:
            log.warning(
                "No valid motor position combination for active heliostat number(s): %s.",
                invalid,
            )
    return _mm(orientations, initial_orientation_offset(device)), motor_positions

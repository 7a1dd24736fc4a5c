"""Actuator models: motor positions <-> joint angles, pure functions.

Counterpart of ``artist_tpu/field/actuators.py``. Conversions are functions
over packed parameter tensors, dispatched on the actuator type string.

Packed layout (shared with the scenario HDF5 schema):
- non-optimizable ``[H, 7, 2]`` (linear) rows:
  [type, clockwise, min_pos, max_pos, increment, offset, pivot_radius]
- non-optimizable ``[H, 4, 2]`` (ideal) rows: [type, clockwise, min, max]
- optimizable ``[H, 2, 2]`` (linear) rows: [initial_angle, initial_stroke_length]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from artist_tpu_torch.util import constants, indices

EPSILON = 1e-6


def _softplus_beta100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100 and PyTorch's linear passthrough above 20."""
    return F.softplus(x, beta=100.0, threshold=20.0)


def physics_informed_linear_parameters(
    non_optimizable: torch.Tensor, optimizable: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp the strictly positive linear-actuator parameters via softplus.

    Parameters
    ----------
    non_optimizable : torch.Tensor
        ``[H, 7, 2]``.
    optimizable : torch.Tensor
        ``[H, 2, 2]``.
    """
    rows = [
        non_optimizable[:, indices.actuator_type],
        non_optimizable[:, indices.actuator_clockwise_movement],
        non_optimizable[:, indices.actuator_min_motor_position],
        non_optimizable[:, indices.actuator_max_motor_position],
        _softplus_beta100(non_optimizable[:, indices.actuator_increment]) + EPSILON,
        _softplus_beta100(non_optimizable[:, indices.actuator_offset]) + EPSILON,
        _softplus_beta100(non_optimizable[:, indices.actuator_pivot_radius]) + EPSILON,
    ]
    opt_rows = [
        optimizable[:, indices.actuator_initial_angle],
        _softplus_beta100(optimizable[:, indices.actuator_initial_stroke_length])
        + EPSILON,
    ]
    return torch.stack(rows, dim=1), torch.stack(opt_rows, dim=1)


def _linear_motor_positions_to_absolute_angles(
    motor_positions: torch.Tensor,
    increment: torch.Tensor,
    offsets: torch.Tensor,
    pivot_radii: torch.Tensor,
    initial_stroke_lengths: torch.Tensor,
) -> torch.Tensor:
    """Law-of-cosines arccos: motor steps -> absolute actuator angles."""
    stroke_lengths = motor_positions / increment + initial_stroke_lengths
    min_stroke = torch.abs(offsets - pivot_radii) + EPSILON
    max_stroke = offsets + pivot_radii - EPSILON
    stroke_lengths = torch.clamp(stroke_lengths, min_stroke, max_stroke)

    numerator = offsets**2 + pivot_radii**2 - stroke_lengths**2
    denominator = 2.0 * offsets * pivot_radii
    return torch.arccos(torch.clamp(numerator / denominator, -1.0 + 1e-6, 1.0 - 1e-6))


def linear_motor_positions_to_angles(
    non_optimizable: torch.Tensor,
    optimizable: torch.Tensor,
    motor_positions: torch.Tensor,
) -> torch.Tensor:
    """Joint angles ``[H, 2]`` from motor positions ``[H, 2]`` (lead-screw actuators)."""
    phys_non_opt, phys_opt = physics_informed_linear_parameters(
        non_optimizable, optimizable
    )
    increment = phys_non_opt[:, indices.actuator_increment]
    offsets = phys_non_opt[:, indices.actuator_offset]
    pivot_radii = phys_non_opt[:, indices.actuator_pivot_radius]
    initial_angles = phys_opt[:, indices.actuator_initial_angle]
    initial_strokes = phys_opt[:, indices.actuator_initial_stroke_length]

    absolute_angles = _linear_motor_positions_to_absolute_angles(
        motor_positions, increment, offsets, pivot_radii, initial_strokes
    )
    absolute_initial_angles = _linear_motor_positions_to_absolute_angles(
        torch.zeros_like(motor_positions), increment, offsets, pivot_radii, initial_strokes
    )
    delta_angles = absolute_initial_angles - absolute_angles

    clockwise = non_optimizable[:, indices.actuator_clockwise_movement] == 1
    return initial_angles + torch.where(clockwise, delta_angles, -delta_angles)


def linear_angles_to_motor_positions(
    non_optimizable: torch.Tensor,
    optimizable: torch.Tensor,
    angles: torch.Tensor,
) -> torch.Tensor:
    """Motor positions from joint angles (inverse of the above)."""
    phys_non_opt, phys_opt = physics_informed_linear_parameters(
        non_optimizable, optimizable
    )
    increment = phys_non_opt[:, indices.actuator_increment]
    offsets = phys_non_opt[:, indices.actuator_offset]
    pivot_radii = phys_non_opt[:, indices.actuator_pivot_radius]
    initial_delta_angles = phys_opt[:, indices.actuator_initial_angle]
    initial_strokes = phys_opt[:, indices.actuator_initial_stroke_length]

    clockwise = non_optimizable[:, indices.actuator_clockwise_movement] == 1
    delta_angles = torch.where(
        clockwise, angles - initial_delta_angles, initial_delta_angles - angles
    )

    absolute_initial_angles = _linear_motor_positions_to_absolute_angles(
        torch.zeros_like(angles), increment, offsets, pivot_radii, initial_strokes
    )
    initial_angles = absolute_initial_angles - delta_angles
    cos_initial = torch.clamp(torch.cos(initial_angles), -1.0 + 1e-6, 1.0 - 1e-6)

    stroke_lengths = torch.sqrt(
        offsets**2 + pivot_radii**2 - 2.0 * offsets * pivot_radii * cos_initial
    )
    min_stroke = torch.abs(offsets - pivot_radii) + EPSILON
    max_stroke = offsets + pivot_radii - EPSILON
    stroke_lengths = torch.clamp(stroke_lengths, min_stroke, max_stroke)

    return (stroke_lengths - initial_strokes) * increment


def ideal_motor_positions_to_angles(
    non_optimizable: torch.Tensor,
    optimizable: torch.Tensor,
    motor_positions: torch.Tensor,
) -> torch.Tensor:
    """Identity motor -> angle mapping (ideal actuators)."""
    del non_optimizable, optimizable
    return motor_positions


def ideal_angles_to_motor_positions(
    non_optimizable: torch.Tensor,
    optimizable: torch.Tensor,
    angles: torch.Tensor,
) -> torch.Tensor:
    """Identity angle -> motor mapping (ideal actuators)."""
    del non_optimizable, optimizable
    return angles


_MOTOR_TO_ANGLES = {
    constants.linear_actuator_key: linear_motor_positions_to_angles,
    constants.ideal_actuator_key: ideal_motor_positions_to_angles,
}
_ANGLES_TO_MOTOR = {
    constants.linear_actuator_key: linear_angles_to_motor_positions,
    constants.ideal_actuator_key: ideal_angles_to_motor_positions,
}


def motor_positions_to_angles(
    actuator_type: str,
    non_optimizable: torch.Tensor,
    optimizable: torch.Tensor,
    motor_positions: torch.Tensor,
) -> torch.Tensor:
    """Dispatch on the actuator type string."""
    return _MOTOR_TO_ANGLES[actuator_type](non_optimizable, optimizable, motor_positions)


def angles_to_motor_positions(
    actuator_type: str,
    non_optimizable: torch.Tensor,
    optimizable: torch.Tensor,
    angles: torch.Tensor,
) -> torch.Tensor:
    """Dispatch on the actuator type string."""
    return _ANGLES_TO_MOTOR[actuator_type](non_optimizable, optimizable, angles)

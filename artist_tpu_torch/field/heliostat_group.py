"""Heliostat group: structure-of-arrays scene state and alignment.

Counterpart of ``artist_tpu/field/heliostat_group.py``. The state is a
frozen dataclass of tensors; "activation" is a gather by a
sample -> heliostat index map, so activating k calibration samples of one
heliostat is that heliostat's index appearing k times.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from artist_tpu_torch.field import kinematics_rigid_body as rigid_body
from artist_tpu_torch.util import constants


@dataclasses.dataclass(frozen=True)
class HeliostatGroupState:
    """SoA tensors for all heliostats sharing one kinematics/actuator type.

    Shapes: H = heliostats, F = facets per heliostat, P = surface points
    (combined over facets), Cu/Cv = control points per direction.
    """

    positions: torch.Tensor  # [H, 4]
    surface_points: torch.Tensor  # [H, P, 4] (heliostat frame)
    surface_normals: torch.Tensor  # [H, P, 4]
    canting: torch.Tensor  # [H, F, 2, 4]
    facet_translations: torch.Tensor  # [H, F, 4]
    nurbs_control_points: torch.Tensor  # [H, F, Cu, Cv, 3]
    initial_orientations: torch.Tensor  # [H, 4]
    translation_deviations: torch.Tensor  # [H, 9]
    rotation_deviations: torch.Tensor  # [H, 4]
    actuator_non_optimizable: torch.Tensor  # [H, 7, 2] linear / [H, 4, 2] ideal
    actuator_optimizable: torch.Tensor  # [H, 2, 2] linear / [0, 0] ideal
    motor_positions: torch.Tensor  # [H, 2]

    # Metadata (not tensors).
    names: tuple = ()
    kinematics_type: str = constants.rigid_body_key
    actuator_type: str = constants.linear_actuator_key
    nurbs_degrees: tuple = (3, 3)

    @property
    def number_of_heliostats(self) -> int:
        return self.positions.shape[0]

    @property
    def number_of_facets_per_heliostat(self) -> int:
        return self.canting.shape[1]

    def replace(self, **changes) -> HeliostatGroupState:
        return dataclasses.replace(self, **changes)


def active_indices_from_mask(active_heliostats_mask: np.ndarray) -> np.ndarray:
    """Host-side sample -> heliostat index map from a multiplicity mask.

    ``mask = [2, 0, 1]`` -> ``[0, 0, 2]``: heliostat 0 twice, heliostat 2
    once; :func:`gather_active` with it is the activation, and the gradients
    of a heliostat's repeated samples sum into its one row.
    """
    mask = np.asarray(active_heliostats_mask)
    return np.repeat(np.arange(mask.shape[0], dtype=np.int32), mask)


def gather_active(
    state: HeliostatGroupState, active_indices: torch.Tensor
) -> HeliostatGroupState:
    """Per-sample copies of all SoA tensors (the 'activated' view), leading axis M."""

    def take(x: torch.Tensor) -> torch.Tensor:
        return torch.index_select(x, 0, active_indices)

    return state.replace(
        positions=take(state.positions),
        surface_points=take(state.surface_points),
        surface_normals=take(state.surface_normals),
        canting=take(state.canting),
        facet_translations=take(state.facet_translations),
        nurbs_control_points=take(state.nurbs_control_points),
        initial_orientations=take(state.initial_orientations),
        translation_deviations=take(state.translation_deviations),
        rotation_deviations=take(state.rotation_deviations),
        actuator_non_optimizable=take(state.actuator_non_optimizable),
        actuator_optimizable=(
            take(state.actuator_optimizable)
            if state.actuator_optimizable.numel()
            else state.actuator_optimizable
        ),
        motor_positions=take(state.motor_positions),
    )


def apply_orientations(
    points: torch.Tensor, normals: torch.Tensor, orientations: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Points/normals ``[M, P, 4]`` into the world frame: row vectors ``x @ O^T``."""
    o_t = orientations.transpose(-1, -2)
    return torch.matmul(points, o_t), torch.matmul(normals, o_t)


def align_surfaces_with_incident_ray_directions(
    active: HeliostatGroupState,
    aim_points: torch.Tensor,
    incident_ray_directions: torch.Tensor,
    warn_invalid: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align active surfaces so reflections hit the aim points.

    Parameters
    ----------
    active : HeliostatGroupState
        Activated (gathered) group state with leading axis M.
    aim_points, incident_ray_directions : torch.Tensor
        ``[M, 4]`` each.
    warn_invalid : bool
        Log heliostats without a valid motor solution (one host sync per
        call, see :func:`~artist_tpu_torch.field.kinematics_rigid_body.incident_ray_directions_to_orientations`).

    Returns
    -------
    tuple
        (aligned_points [M, P, 4], aligned_normals [M, P, 4],
        orientations [M, 4, 4], motor_positions [M, 2]).
    """
    orientations, motor_positions = rigid_body.incident_ray_directions_to_orientations(
        incident_ray_directions=incident_ray_directions,
        aim_points=aim_points,
        heliostat_positions=active.positions,
        translation_deviations=active.translation_deviations,
        rotation_deviations=active.rotation_deviations,
        actuator_type=active.actuator_type,
        actuator_non_optimizable=active.actuator_non_optimizable,
        actuator_optimizable=active.actuator_optimizable,
        warn_invalid=warn_invalid,
    )
    points, normals = apply_orientations(
        active.surface_points, active.surface_normals, orientations
    )
    return points, normals, orientations, motor_positions


def align_surfaces_with_motor_positions(
    active: HeliostatGroupState, motor_positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align active surfaces for given motor positions ``[M, 2]``.

    Returns
    -------
    tuple
        (aligned_points [M, P, 4], aligned_normals [M, P, 4],
        orientations [M, 4, 4]).
    """
    orientations = rigid_body.motor_positions_to_orientations(
        motor_positions=motor_positions,
        heliostat_positions=active.positions,
        translation_deviations=active.translation_deviations,
        rotation_deviations=active.rotation_deviations,
        actuator_type=active.actuator_type,
        actuator_non_optimizable=active.actuator_non_optimizable,
        actuator_optimizable=active.actuator_optimizable,
    )
    points, normals = apply_orientations(
        active.surface_points, active.surface_normals, orientations
    )
    return points, normals, orientations

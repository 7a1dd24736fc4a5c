"""Scenario: the runtime scene root.

Counterpart of the ``Scenario`` dataclass in ``artist_tpu/scenario/scenario.py``
(the container and ``update_surfaces``; the HDF5 loader is not ported yet). Device state is
one :class:`~artist_tpu_torch.field.heliostat_group.HeliostatGroupState` per
(kinematics, actuator) group plus a
:class:`~artist_tpu_torch.field.solar_tower.SolarTower`.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field as dataclass_field

import math

import numpy as np
import torch

from artist_tpu_torch.field.heliostat_group import HeliostatGroupState
from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.scene.sun import Sun


@dataclass
class Scenario:
    """Runtime scene root."""

    power_plant_position: np.ndarray  # [3] float64 WGS84
    solar_tower: SolarTower
    light_sources: list[Sun]
    heliostat_groups: list[HeliostatGroupState]
    heliostat_group_names: list[str] = dataclass_field(default_factory=list)

    @property
    def number_of_heliostat_groups(self) -> int:
        return len(self.heliostat_groups)

    def index_mapping(
        self,
        heliostat_group: HeliostatGroupState,
        string_mapping: list[tuple[str, str, np.ndarray]] | None = None,
        single_incident_ray_direction: np.ndarray | None = None,
        single_target_area_index: int = 0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Heliostat/target/incident-direction mapping -> batched host arrays.

        Returns
        -------
        tuple of np.ndarray
            (active_heliostats_mask [H] int32, target_area_indices [M] int32,
            incident_ray_directions [M, 4] float32), ordered by heliostat
            position in the group.
        """
        if single_incident_ray_direction is None:
            single_incident_ray_direction = np.array(
                [0.0, 1.0, 0.0, 0.0], dtype=np.float32
            )
        single_incident_ray_direction = np.asarray(
            single_incident_ray_direction, dtype=np.float32
        )
        total_number_of_target_areas = self.solar_tower.number_of_target_areas

        if string_mapping is None:
            if (
                single_incident_ray_direction.shape != (4,)
                or abs(single_incident_ray_direction[3]) > 1e-8
                or abs(np.linalg.norm(single_incident_ray_direction[:3]) - 1.0) > 1e-5
            ):
                raise ValueError(
                    "The specified single incident ray direction is invalid. "
                    "Please provide a normalized 4D tensor with last element 0.0."
                )
            if single_target_area_index >= total_number_of_target_areas:
                raise ValueError(
                    f"The specified single target area index is invalid. Only "
                    f"{total_number_of_target_areas} target areas exist in this scenario."
                )
            num = heliostat_group.number_of_heliostats
            return (
                np.ones(num, dtype=np.int32),
                np.full(num, single_target_area_index, dtype=np.int32),
                np.broadcast_to(single_incident_ray_direction, (num, 4)).copy(),
            )

        name_to_index = self.solar_tower.target_name_to_index
        filtered = [m for m in string_mapping if m[0] in heliostat_group.names]
        errors = []
        for i, (_, target_name, light_direction) in enumerate(filtered):
            light_direction = np.asarray(light_direction, dtype=np.float32)
            if target_name not in name_to_index:
                errors.append(
                    f"Invalid target '{target_name}' (Found at index {i} of provided "
                    f"mapping) not found in this scenario."
                )
            if (
                light_direction.shape != (4,)
                or abs(light_direction[3]) > 1e-2
                or abs(np.linalg.norm(light_direction) - 1.0) > 1e-3
            ):
                errors.append(
                    f"Invalid incident ray direction (Found at index {i} of provided "
                    f"mapping). This must be a normalized 4D tensor with last element 0.0."
                )
        if errors:
            raise ValueError(" ".join(errors))

        heliostat_name_to_index = {
            name: i for i, name in enumerate(heliostat_group.names)
        }
        mask = np.zeros(heliostat_group.number_of_heliostats, dtype=np.int32)
        data_per_heliostat = defaultdict(list)
        for heliostat_name, target_name, light_direction in filtered:
            mask[heliostat_name_to_index[heliostat_name]] += 1
            data_per_heliostat[heliostat_name].append(
                (name_to_index[target_name], np.asarray(light_direction, np.float32))
            )
        target_area_indices = np.empty(len(filtered), dtype=np.int32)
        incident_ray_directions = np.empty((len(filtered), 4), dtype=np.float32)
        index = 0
        for name in heliostat_group.names:
            for target_index, direction in data_per_heliostat.get(name, []):
                target_area_indices[index] = target_index
                incident_ray_directions[index] = direction
                index += 1
        return mask, target_area_indices, incident_ray_directions


@torch.no_grad()
def update_surfaces(
    group: HeliostatGroupState,
    number_of_surface_points_per_facet: tuple[int, int] | None = None,
) -> HeliostatGroupState:
    """The group with its canonical surface points and normals re-evaluated from its
    NURBS control points, outside the autograd graph.

    ``number_of_surface_points_per_facet`` defaults to a square grid of the
    group's current count per facet.
    """
    if number_of_surface_points_per_facet is None:
        per_facet = group.surface_points.shape[1] // group.number_of_facets_per_heliostat
        side = int(math.sqrt(per_facet))
        number_of_surface_points_per_facet = (side, side)
    control_points = group.nurbs_control_points.detach()
    points, normals = evaluate_nurbs_surfaces(
        control_points,
        group.nurbs_degrees,
        create_nurbs_evaluation_grid(number_of_surface_points_per_facet, device=control_points.device),
        canting=group.canting,
        facet_translations=group.facet_translations,
    )
    num = group.number_of_heliostats
    return group.replace(
        surface_points=points.reshape(num, -1, 4),
        surface_normals=normals.reshape(num, -1, 4),
    )

"""Scenario: the runtime scene root, and its loader from scenario HDF5 files.

Counterpart of ``artist_tpu/scenario/scenario.py``. Device state is one
:class:`~artist_tpu_torch.field.heliostat_group.HeliostatGroupState` per
(kinematics, actuator) group plus a
:class:`~artist_tpu_torch.field.solar_tower.SolarTower`.

The loader reads the file on the host (:func:`_read_heliostats` and the
``_load_*`` readers, which take open ``h5py`` objects), then builds the
groups on the device (:func:`_assemble_heliostat_groups`, which samples each
distinct surface once with :func:`sample_surface`). ``h5py`` is imported only
by the two functions that open a file.
"""

from __future__ import annotations

import logging
import math
import pathlib
from collections import defaultdict
from dataclasses import dataclass, field as dataclass_field

import numpy as np
import torch

from artist_tpu_torch.field.heliostat_group import HeliostatGroupState
from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.geometry.rotations import rotation_angle_and_axis
from artist_tpu_torch.nurbs import (
    create_nurbs_evaluation_grid,
    create_planar_nurbs_control_points,
    evaluate_nurbs_surfaces,
)
from artist_tpu_torch.scene.sun import Sun
from artist_tpu_torch.util import constants, indices

log = logging.getLogger("artist_tpu_torch.scenario")


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


def get_number_of_heliostat_groups_from_hdf5(scenario_path: pathlib.Path | str) -> int:
    """The number of heliostat groups a scenario file declares."""
    import h5py

    with h5py.File(scenario_path) as scenario_file:
        return int(scenario_file[constants.number_of_heliostat_groups][()])


def _load_solar_tower(scenario_file, device: torch.device | str) -> SolarTower:
    """The tower's planar and cylindrical target areas, on ``device``."""
    planar_names, planar_centers, planar_normals, planar_dims = [], [], [], []
    if constants.target_area_planar_key in scenario_file:
        for name, group in scenario_file[constants.target_area_planar_key].items():
            planar_names.append(name)
            planar_centers.append(
                np.asarray(group[constants.target_area_position_center][()], np.float32)
            )
            planar_normals.append(
                np.asarray(
                    group[constants.target_area_normal_vector][()], np.float32
                ).reshape(-1)[:4]
            )
            planar_dims.append(
                [
                    float(group[constants.target_area_plane_e][()]),
                    float(group[constants.target_area_plane_u][()]),
                ]
            )

    cyl_names, cyl_centers, cyl_axes, cyl_normals = [], [], [], []
    cyl_radii, cyl_heights, cyl_angles = [], [], []
    if constants.target_area_cylindrical_key in scenario_file:
        for name, group in scenario_file[constants.target_area_cylindrical_key].items():
            cyl_names.append(name)
            cyl_centers.append(
                np.asarray(group[constants.target_area_cylinder_center][()], np.float32)
            )
            cyl_axes.append(
                np.asarray(group[constants.target_area_cylinder_axis][()], np.float32)
            )
            cyl_normals.append(
                np.asarray(group[constants.target_area_cylinder_normal][()], np.float32)
            )
            cyl_radii.append(float(group[constants.target_area_cylinder_radius][()]))
            cyl_heights.append(float(group[constants.target_area_cylinder_height][()]))
            cyl_angles.append(
                float(group[constants.target_area_cylinder_opening_angle][()])
            )

    def arr(x, shape):
        if not x:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return torch.tensor(np.stack(x), dtype=torch.float32, device=device)

    return SolarTower(
        planar_centers=arr(planar_centers, (0, 4)),
        planar_normals=arr(planar_normals, (0, 4)),
        planar_dimensions=arr(planar_dims, (0, 2)),
        cylindrical_centers=arr(cyl_centers, (0, 4)),
        cylindrical_axes=arr(cyl_axes, (0, 4)),
        cylindrical_normals=arr(cyl_normals, (0, 4)),
        cylindrical_radii=arr(cyl_radii, (0,)),
        cylindrical_heights=arr(cyl_heights, (0,)),
        cylindrical_opening_angles=arr(cyl_angles, (0,)),
        planar_names=tuple(planar_names),
        cylindrical_names=tuple(cyl_names),
    )


def _load_light_sources(scenario_file) -> list[Sun]:
    """The scenario's light sources, through the type registry."""
    from artist_tpu_torch.util.type_registry import light_source_type_mapping

    sources = []
    for name, group in scenario_file[constants.light_source_key].items():
        light_source_type = group[constants.light_source_type][()].decode("utf-8")
        if light_source_type not in light_source_type_mapping:
            raise ValueError(f"Unknown light source type: {light_source_type}")
        light_source_cls = light_source_type_mapping[light_source_type]
        dist_group = group[constants.light_source_distribution_parameters]
        params = {
            constants.light_source_distribution_type: dist_group[
                constants.light_source_distribution_type
            ][()].decode("utf-8")
        }
        if constants.light_source_mean in dist_group:
            params[constants.light_source_mean] = float(
                dist_group[constants.light_source_mean][()]
            )
        if constants.light_source_covariance in dist_group:
            params[constants.light_source_covariance] = float(
                dist_group[constants.light_source_covariance][()]
            )
        sources.append(
            light_source_cls(
                number_of_rays=int(group[constants.light_source_number_of_rays][()]),
                distribution_parameters=params,
            )
        )
    return sources


def _load_surface_config(facets_group) -> dict:
    """Per-facet host arrays from a surface's facets group."""
    control_points, degrees, translations, cantings = [], None, [], []
    for facet_name in facets_group.keys():
        facet = facets_group[facet_name]
        control_points.append(
            np.asarray(facet[constants.facet_control_points][()], np.float32)
        )
        degrees = np.asarray(facet[constants.facet_degrees][()], np.int32)
        translations.append(
            np.asarray(facet[constants.facets_translation_vector][()], np.float32)
        )
        cantings.append(np.asarray(facet[constants.facets_canting][()], np.float32))
    return {
        "control_points": np.stack(control_points),  # [F, Cu, Cv, 3]
        "degrees": degrees,  # [2]
        "translations": np.stack(translations),  # [F, 4]
        "canting": np.stack(cantings),  # [F, 2, 4]
    }


TRANSLATION_DEVIATION_KEYS = (
    constants.first_joint_translation_e,
    constants.first_joint_translation_n,
    constants.first_joint_translation_u,
    constants.second_joint_translation_e,
    constants.second_joint_translation_n,
    constants.second_joint_translation_u,
    constants.concentrator_translation_e,
    constants.concentrator_translation_n,
    constants.concentrator_translation_u,
)
ROTATION_DEVIATION_KEYS = (
    constants.first_joint_tilt_n,
    constants.first_joint_tilt_u,
    constants.second_joint_tilt_e,
    constants.second_joint_tilt_n,
)


def _load_kinematics(kinematics_group, owner: str = "prototype") -> dict:
    """Kinematics type, initial orientation and packed deviations (host).

    A missing deviation is 0, with a warning naming it and its ``owner``
    (a heliostat's name, or "prototype").
    """
    kinematics_type = kinematics_group[constants.kinematics_type][()].decode("utf-8")
    if kinematics_type != constants.rigid_body_key:
        raise ValueError(f"The kinematics type: {kinematics_type} is not yet implemented!")
    initial_orientation = np.asarray(
        kinematics_group[constants.kinematics_initial_orientation][()], np.float32
    )
    deviations = kinematics_group.get(constants.kinematics_deviations)

    def read(keys) -> np.ndarray:
        values = np.zeros(len(keys), np.float32)
        for row, key in enumerate(keys):
            if deviations is not None and key in deviations:
                values[row] = float(deviations[key][()])
            else:
                log.warning("No kinematics deviation %s for %s set. Using default 0.", key, owner)
        return values

    return {
        "type": kinematics_type,
        "initial_orientation": initial_orientation,
        "translation_deviations": read(TRANSLATION_DEVIATION_KEYS),
        "rotation_deviations": read(ROTATION_DEVIATION_KEYS),
    }


def _initial_angle_compensation() -> float:
    """Initial-angle delta for actuator one: the east component of the
    rotation from the kinematics' standard orientation (south) to the
    sampled surface's (up), which is -pi/2."""
    axis, angle = rotation_angle_and_axis(
        np.array([0.0, -1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0, 0.0])
    )
    return float(axis[indices.e] * angle)


def _load_actuators(actuator_group, prototype: bool = False, owner: str = "prototype") -> dict:
    """Packed actuator parameters (host) from an actuator group.

    A missing linear-actuator parameter is 0, with a warning naming it, the
    actuator and its ``owner``.
    """
    actuator_names = list(actuator_group.keys())
    number_of_actuators = len(actuator_names)
    if number_of_actuators != constants.rigid_body_number_of_actuators:
        raise ValueError(
            f"This scenario file contains the wrong amount of actuators for this "
            f"heliostat and its kinematics type. Expected "
            f"{constants.rigid_body_number_of_actuators} actuators, found "
            f"{number_of_actuators} actuator(s)."
        )
    types = [
        actuator_group[a][constants.actuator_type_key][()].decode("utf-8")
        for a in actuator_names
    ]
    if len(set(types)) > 1:
        if prototype:
            raise ValueError("Prototype actuators must all have the same type.")
        raise ValueError(
            "When using the rigid body kinematics, all actuators for a given "
            "heliostat must have the same type."
        )
    actuator_type = types[0]

    if actuator_type == constants.linear_actuator_key:
        non_optimizable = np.zeros((7, number_of_actuators), np.float32)
        optimizable = np.zeros((2, number_of_actuators), np.float32)
        type_int = constants.linear_actuator_int
    elif actuator_type == constants.ideal_actuator_key:
        non_optimizable = np.zeros((4, number_of_actuators), np.float32)
        optimizable = np.zeros((0, 0), np.float32)
        type_int = constants.ideal_actuator_int
    else:
        raise ValueError(f"The actuator type: {actuator_type} is not yet implemented!")

    for column, name in enumerate(actuator_names):
        actuator = actuator_group[name]
        non_optimizable[indices.actuator_type, column] = type_int
        non_optimizable[indices.actuator_clockwise_movement, column] = float(
            bool(actuator[constants.actuator_clockwise_axis_movement][()])
        )
        min_max = actuator[constants.actuator_min_max_motor_positions][()]
        non_optimizable[indices.actuator_min_motor_position, column] = float(
            min_max[indices.data_actuator_min_motor_position]
        )
        non_optimizable[indices.actuator_max_motor_position, column] = float(
            min_max[indices.data_actuator_max_motor_position]
        )
        if actuator_type != constants.linear_actuator_key:
            continue
        params = actuator.get(constants.actuator_parameters_key)
        for target, row, key in (
            (non_optimizable, indices.actuator_increment, constants.actuator_increment),
            (non_optimizable, indices.actuator_offset, constants.actuator_offset),
            (non_optimizable, indices.actuator_pivot_radius, constants.actuator_pivot_radius),
            (optimizable, indices.actuator_initial_angle, constants.actuator_initial_angle),
            (optimizable, indices.actuator_initial_stroke_length, constants.actuator_initial_stroke_length),
        ):
            if params is not None and key in params:
                target[row, column] = float(params[key][()])
            else:
                log.warning("No individual %s set for %s on %s. Using default 0.", key, name, owner)

    if actuator_type == constants.linear_actuator_key:
        # Actuator one's initial angle, compensated for the surface-up against
        # the kinematics-south orientation.
        optimizable[indices.actuator_initial_angle, indices.actuator_one_index] += (
            _initial_angle_compensation()
        )
    return {
        "type": actuator_type,
        "non_optimizable": non_optimizable,
        "optimizable": optimizable,
    }


def sample_surface(
    surface: dict,
    number_of_surface_points_per_facet: tuple[int, int],
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Surface points and normals of one heliostat, sampled from its NURBS on ``device``.

    Canting (and the facet translations) is applied only where the control
    points are planar: control points fitted to deflectometry already hold
    the facets' shape and place.

    Parameters
    ----------
    surface : dict
        Host arrays as :func:`_load_surface_config` returns them.
    number_of_surface_points_per_facet : tuple[int, int]
        The sampling grid of each facet.

    Returns
    -------
    tuple of torch.Tensor
        Points and normals, each ``[F, P, 4]``.
    """
    control_points = torch.tensor(surface["control_points"][None], dtype=torch.float32, device=device)
    degrees = (int(surface["degrees"][0]), int(surface["degrees"][1]))
    evaluation_points = create_nurbs_evaluation_grid(number_of_surface_points_per_facet, device=device)
    if bool(np.all(surface["control_points"][..., 2] == 0)):
        points, normals = evaluate_nurbs_surfaces(
            control_points,
            degrees,
            evaluation_points,
            canting=torch.tensor(surface["canting"][None], dtype=torch.float32, device=device),
            facet_translations=torch.tensor(surface["translations"][None], dtype=torch.float32, device=device),
        )
    else:
        points, normals = evaluate_nurbs_surfaces(control_points, degrees, evaluation_points)
    return points[0], normals[0]


def _read_heliostats(scenario_file) -> list[dict]:
    """Each heliostat of an open scenario file, in the file's key order, as a
    dict of host arrays: ``name``, ``position`` and the ``surface``,
    ``kinematics`` and ``actuator`` dicts of the ``_load_*`` readers, a
    prototype's wherever the heliostat has none of its own."""
    prototypes = scenario_file[constants.prototype_key]
    prototype_surface = _load_surface_config(
        prototypes[constants.surface_prototype_key][constants.facets_key]
    )
    prototype_kinematics = _load_kinematics(prototypes[constants.kinematics_prototype_key])
    prototype_actuators = _load_actuators(
        prototypes[constants.actuators_prototype_key], prototype=True
    )

    heliostats = []
    for heliostat_name in scenario_file[constants.heliostat_key].keys():
        heliostat = scenario_file[constants.heliostat_key][heliostat_name]

        if constants.heliostat_surface_key in heliostat:
            surface = _load_surface_config(
                heliostat[constants.heliostat_surface_key][constants.facets_key]
            )
        else:
            log.info(
                "Individual surface parameters not provided - loading "
                "heliostat %s with the surface prototype.",
                heliostat_name,
            )
            surface = prototype_surface

        if constants.heliostat_kinematics_key in heliostat:
            kinematics = _load_kinematics(
                heliostat[constants.heliostat_kinematics_key], owner=heliostat_name
            )
        else:
            log.info(
                "Individual kinematics configuration not provided - loading "
                "heliostat %s with the kinematics prototype.",
                heliostat_name,
            )
            kinematics = prototype_kinematics

        if constants.heliostat_actuator_key in heliostat:
            actuator = _load_actuators(
                heliostat[constants.heliostat_actuator_key], owner=heliostat_name
            )
        else:
            log.info(
                "Individual actuator configuration not provided - loading "
                "heliostat %s with the actuator prototype.",
                heliostat_name,
            )
            actuator = prototype_actuators

        heliostats.append(
            {
                "name": heliostat_name,
                "position": np.asarray(heliostat[constants.heliostat_position][()], np.float32),
                "surface": surface,
                "kinematics": kinematics,
                "actuator": actuator,
            }
        )
    return heliostats


def _assemble_heliostat_groups(
    heliostats: list[dict],
    number_of_surface_points_per_facet: tuple[int, int],
    change_number_of_control_points_per_facet: tuple[int, int] | None,
    device: torch.device | str,
) -> tuple[list[HeliostatGroupState], list[str]]:
    """One group a (kinematics, actuator) type on ``device``, in the order of
    the types' first appearance, from :func:`_read_heliostats`'s dicts.

    Heliostats with equal control points, canting and translations share one
    :func:`sample_surface` call. Returns the groups and their type keys.
    """
    grouped: dict[str, dict] = {}
    surface_cache: dict[bytes, tuple[torch.Tensor, torch.Tensor]] = {}
    for heliostat in heliostats:
        surface, kinematics, actuator = heliostat["surface"], heliostat["kinematics"], heliostat["actuator"]
        if change_number_of_control_points_per_facet is not None:
            surface = dict(
                surface,
                control_points=create_planar_nurbs_control_points(
                    change_number_of_control_points_per_facet, torch.tensor(surface["canting"])
                ).numpy(),
            )
        cache_key = (
            surface["control_points"].tobytes()
            + surface["canting"].tobytes()
            + surface["translations"].tobytes()
        )
        if cache_key not in surface_cache:
            surface_cache[cache_key] = sample_surface(surface, number_of_surface_points_per_facet, device)
        points, normals = surface_cache[cache_key]

        g = grouped.setdefault(f"{kinematics['type']}_{actuator['type']}", defaultdict(list))
        g["names"].append(heliostat["name"])
        g["positions"].append(heliostat["position"])
        g["surface_points"].append(points.reshape(-1, 4))
        g["surface_normals"].append(normals.reshape(-1, 4))
        g["canting"].append(surface["canting"])
        g["facet_translations"].append(surface["translations"])
        g["control_points"].append(surface["control_points"])
        g["degrees"] = surface["degrees"]
        g["initial_orientations"].append(kinematics["initial_orientation"])
        g["translation_deviations"].append(kinematics["translation_deviations"])
        g["rotation_deviations"].append(kinematics["rotation_deviations"])
        g["actuator_non_optimizable"].append(actuator["non_optimizable"])
        g["actuator_optimizable"].append(actuator["optimizable"])
        g["types"] = (kinematics["type"], actuator["type"])

    def stacked(arrays: list[np.ndarray]) -> torch.Tensor:
        return torch.tensor(np.stack(arrays), dtype=torch.float32, device=device)

    heliostat_groups = []
    for g in grouped.values():
        kinematics_type, actuator_type = g["types"]
        heliostat_groups.append(
            HeliostatGroupState(
                positions=stacked(g["positions"]),
                surface_points=torch.stack(g["surface_points"]),
                surface_normals=torch.stack(g["surface_normals"]),
                canting=stacked(g["canting"]),
                facet_translations=stacked(g["facet_translations"]),
                nurbs_control_points=stacked(g["control_points"]),
                initial_orientations=stacked(g["initial_orientations"]),
                translation_deviations=stacked(g["translation_deviations"]),
                rotation_deviations=stacked(g["rotation_deviations"]),
                actuator_non_optimizable=stacked(g["actuator_non_optimizable"]),
                actuator_optimizable=stacked(g["actuator_optimizable"]),
                motor_positions=torch.zeros((len(g["names"]), 2), dtype=torch.float32, device=device),
                names=tuple(g["names"]),
                kinematics_type=kinematics_type,
                actuator_type=actuator_type,
                nurbs_degrees=(int(g["degrees"][0]), int(g["degrees"][1])),
            )
        )
        log.info(
            "Added a heliostat group with kinematics type: %s, and actuator "
            "type: %s, to the heliostat field.",
            kinematics_type,
            actuator_type,
        )
    return heliostat_groups, list(grouped)


def load_scenario_from_hdf5(
    scenario_path,
    number_of_surface_points_per_facet: tuple[int, int] = (50, 50),
    change_number_of_control_points_per_facet: tuple[int, int] | None = None,
    device: torch.device | str = "cuda",
) -> Scenario:
    """Load a scenario file onto ``device``.

    Raises ``ImportError`` where ``h5py`` is not installed.

    Parameters
    ----------
    scenario_path : path or open h5py.File
        The scenario file.
    number_of_surface_points_per_facet : tuple[int, int]
        Sampling grid of each facet (default (50, 50)).
    change_number_of_control_points_per_facet : tuple[int, int] | None
        If given, every surface's control points are replaced by planar grids
        of this size (only sensible for ideal surfaces).
    device : torch.device | str
        Where the scenario's tensors live.
    """
    import h5py

    own_handle = not isinstance(scenario_path, h5py.File)
    scenario_file = h5py.File(scenario_path, "r") if own_handle else scenario_path
    try:
        log.info(
            "Loading an ARTIST scenario HDF5 file. This scenario file is version %s.",
            scenario_file.attrs.get("version"),
        )
        power_plant_position = np.asarray(
            scenario_file[constants.power_plant_key][constants.power_plant_position][()],
            np.float64,
        )
        solar_tower = _load_solar_tower(scenario_file, device)
        light_sources = _load_light_sources(scenario_file)
        heliostats = _read_heliostats(scenario_file)
    finally:
        if own_handle:
            scenario_file.close()
    heliostat_groups, heliostat_group_names = _assemble_heliostat_groups(
        heliostats,
        number_of_surface_points_per_facet,
        change_number_of_control_points_per_facet,
        device,
    )
    return Scenario(
        power_plant_position=power_plant_position,
        solar_tower=solar_tower,
        light_sources=light_sources,
        heliostat_groups=heliostat_groups,
        heliostat_group_names=heliostat_group_names,
    )


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

"""PAINT database -> scenario configuration parsers.

Counterpart of ``artist_tpu/io/paint_scenario_parser.py``: host numpy, with
the NURBS fit delegated to
:class:`artist_tpu_torch.scenario.surface_generator.SurfaceGenerator` on the
caller's ``device``. ``h5py`` is imported only by
:func:`extract_paint_deflectometry_data`.
"""

from __future__ import annotations

import json
import logging
import pathlib
import random
from typing import Any

import numpy as np
import torch

from artist_tpu_torch.geometry.coordinates import convert_wgs84_coordinates_to_local_enu
from artist_tpu_torch.scenario.surface_generator import SurfaceGenerator
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.config import (
    ActuatorConfig,
    ActuatorListConfig,
    ActuatorParameters,
    HeliostatConfig,
    HeliostatListConfig,
    KinematicsConfig,
    KinematicsDeviations,
    PowerPlantConfig,
    PrototypeConfig,
    SurfaceConfig,
    TargetAreaCylindricalConfig,
    TargetAreaPlanarConfig,
)

log = logging.getLogger("artist_tpu_torch.io")

# PAINT database schema keys.
POWER_PLANT_KEY = "power_plant_properties"
TOWER_COORDINATES_KEY = "coordinates"
TOWER_NORMAL_VECTOR_KEY = "normal_vector"
TOWER_TYPE_KEY = "type"
CENTER = "center"
UPPER_LEFT = "upper_left"
UPPER_RIGHT = "upper_right"
LOWER_LEFT = "lower_left"
LOWER_RIGHT = "lower_right"
HELIOSTAT_POSITION_KEY = "heliostat_position"
INITIAL_ORIENTATION_KEY = "initial_orientation"
KINEMATICS_PROPERTIES_KEY = "kinematics_properties"
ACTUATOR_KEY = "actuators"
FACET_PROPERTIES_KEY = "facet_properties"
FACETS_LIST = "facets"
NUM_FACETS = "number_of_facets"
TRANSLATION_VECTOR = "translation_vector"
CANTING_E = "canting_e"
CANTING_N = "canting_n"
FACET_KEY = "facet"
SURFACE_POINT_KEY = "surface_points"
SURFACE_NORMAL_KEY = "surface_normals"
CALIBRATION_PROPERTIES_IDENTIFIER = "-calibration-properties.json"
SAVE_CALIBRATION = "Calibration"

_DEVIATION_KEYS = {
    "first_joint_translation_e": "joint_translation_e_1",
    "first_joint_translation_n": "joint_translation_n_1",
    "first_joint_translation_u": "joint_translation_u_1",
    "second_joint_translation_e": "joint_translation_e_2",
    "second_joint_translation_n": "joint_translation_n_2",
    "second_joint_translation_u": "joint_translation_u_2",
    "concentrator_translation_e": "concentrator_translation_e",
    "concentrator_translation_n": "concentrator_translation_n",
    "concentrator_translation_u": "concentrator_translation_u",
}
_ACTUATOR_PARAMETER_KEYS = {
    "increment": "increment",
    "initial_stroke_length": "initial_stroke_length",
    "offset": "offset",
    "pivot_radius": "pivot_radius",
    "initial_angle": "initial_angle",
}


def _to_4d_point(point3: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(point3, np.float32), [1.0]]).astype(np.float32)


def _to_4d_direction(direction) -> np.ndarray:
    direction = np.asarray(direction, np.float32)
    return np.concatenate(
        [direction, np.zeros(direction.shape[:-1] + (1,), np.float32)], axis=-1
    )


def corner_points_to_plane(
    upper_left: np.ndarray,
    upper_right: np.ndarray,
    lower_left: np.ndarray,
    lower_right: np.ndarray,
) -> tuple[float, float]:
    """Plane width/height from the averaged corner spans."""
    plane_e = (
        abs(upper_right[0] - upper_left[0]) + abs(lower_right[0] - lower_left[0])
    ) / 2
    plane_u = (
        abs(upper_left[2] - lower_left[2]) + abs(upper_right[2] - lower_right[2])
    ) / 2
    return float(plane_e), float(plane_u)


def extract_paint_tower_measurements(
    tower_measurements_path: pathlib.Path | str,
) -> tuple[
    PowerPlantConfig, list[TargetAreaPlanarConfig], list[TargetAreaCylindricalConfig]
]:
    """Tower measurement JSON -> power plant + target area configs."""
    log.info("Beginning extraction of tower data from PAINT file.")
    with open(tower_measurements_path) as file:
        tower_dict = json.load(file)

    power_plant_position = np.asarray(
        tower_dict[POWER_PLANT_KEY][TOWER_COORDINATES_KEY], np.float64
    )
    planar_configs: list[TargetAreaPlanarConfig] = []
    cylindrical_configs: list[TargetAreaCylindricalConfig] = []

    for target_area in list(tower_dict.keys())[1:]:
        entry = tower_dict[target_area]
        if entry[TOWER_TYPE_KEY] == "planar":
            corners_wgs84 = np.asarray(
                [
                    entry[TOWER_COORDINATES_KEY][corner]
                    for corner in (UPPER_LEFT, LOWER_LEFT, UPPER_RIGHT, LOWER_RIGHT)
                ],
                np.float64,
            )
            corners_enu = convert_wgs84_coordinates_to_local_enu(
                corners_wgs84, power_plant_position
            )
            upper_left, lower_left, upper_right, lower_right = corners_enu
            plane_e, plane_u = corner_points_to_plane(
                upper_left, upper_right, lower_left, lower_right
            )
            center_enu = convert_wgs84_coordinates_to_local_enu(
                np.asarray([entry[TOWER_COORDINATES_KEY][CENTER]], np.float64),
                power_plant_position,
            )[0]
            planar_configs.append(
                TargetAreaPlanarConfig(
                    target_area_key=target_area,
                    center=_to_4d_point(center_enu),
                    normal_vector=_to_4d_direction(entry[TOWER_NORMAL_VECTOR_KEY]),
                    plane_e=plane_e,
                    plane_u=plane_u,
                )
            )
        if entry[TOWER_TYPE_KEY] == "convex_cylinder":
            prefix = (
                "receiver_inner_"
                if target_area == constants.target_area_receiver
                else ""
            )
            corners_wgs84 = np.asarray(
                [
                    entry[TOWER_COORDINATES_KEY][f"{prefix}{corner}"]
                    for corner in (UPPER_LEFT, LOWER_LEFT, UPPER_RIGHT, LOWER_RIGHT)
                ],
                np.float64,
            )
            corners_enu = convert_wgs84_coordinates_to_local_enu(
                corners_wgs84, power_plant_position
            ).astype(np.float64)
            upper_left, lower_left, upper_right, lower_right = corners_enu
            radius = float(entry["radius"])
            opening_angle = float(np.deg2rad(entry["opening_angle"]))
            normal = np.asarray(entry["normal_vector"], np.float64)
            ortho_radius = np.cross(normal, [0.0, 0.0, 1.0])
            axis = np.cross(ortho_radius, normal)
            axis = axis / np.linalg.norm(axis)

            # Cylinder center/height from the arch corner chords.
            midpoint_lower = (lower_left + lower_right) / 2
            midpoint_upper = (upper_left + upper_right) / 2
            chord_lower = lower_right - lower_left
            chord_upper = upper_right - upper_left
            distance_lower = np.sqrt(
                radius**2 - (np.linalg.norm(chord_lower) / 2) ** 2
            )
            distance_upper = np.sqrt(
                radius**2 - (np.linalg.norm(chord_upper) / 2) ** 2
            )
            center_lower = midpoint_lower - normal * distance_lower
            center_upper = midpoint_upper - normal * distance_upper
            center = (center_lower + center_upper) / 2
            height = float(np.linalg.norm(center_lower - center_upper))

            cylindrical_configs.append(
                TargetAreaCylindricalConfig(
                    target_area_key=target_area,
                    center=_to_4d_point(center),
                    axis=_to_4d_direction(axis),
                    normal_vector=_to_4d_direction(normal),
                    radius=radius,
                    height=height,
                    opening_angle=opening_angle,
                )
            )

    log.info("Loading tower data complete.")
    return (
        PowerPlantConfig(power_plant_position=power_plant_position),
        planar_configs,
        cylindrical_configs,
    )


def extract_paint_heliostat_properties(
    heliostat_properties_path: pathlib.Path | str,
    power_plant_position: np.ndarray,
) -> tuple[
    np.ndarray,
    np.ndarray,
    np.ndarray,
    KinematicsDeviations,
    np.ndarray,
    list[tuple[str, bool, list[float], ActuatorParameters]],
]:
    """Heliostat properties JSON -> position, facets, kinematics, actuators."""
    with open(heliostat_properties_path) as file:
        heliostat_dict = json.load(file)
    log.info("Beginning extraction of heliostat properties data from PAINT file.")

    position3 = convert_wgs84_coordinates_to_local_enu(
        np.asarray([heliostat_dict[HELIOSTAT_POSITION_KEY]], np.float64),
        np.asarray(power_plant_position, np.float64),
    )[0]
    heliostat_position = _to_4d_point(position3)

    facet_properties = heliostat_dict[FACET_PROPERTIES_KEY]
    number_of_facets = facet_properties[NUM_FACETS]
    facet_translation_vectors = np.zeros((number_of_facets, 3), np.float32)
    canting = np.zeros((number_of_facets, 2, 3), np.float32)
    for facet in range(number_of_facets):
        facet_entry = facet_properties[FACETS_LIST][facet]
        facet_translation_vectors[facet] = facet_entry[TRANSLATION_VECTOR]
        canting[facet, 0] = facet_entry[CANTING_E]
        canting[facet, 1] = facet_entry[CANTING_N]

    kinematics_properties = heliostat_dict[KINEMATICS_PROPERTIES_KEY]
    kinematics_deviations = KinematicsDeviations(
        **{
            ours: float(kinematics_properties[theirs])
            for ours, theirs in _DEVIATION_KEYS.items()
        }
    )
    initial_orientation = _to_4d_direction(
        heliostat_dict[INITIAL_ORIENTATION_KEY]
    )

    actuator_parameters_list = []
    for actuator in kinematics_properties[ACTUATOR_KEY]:
        parameters = ActuatorParameters(
            **{
                ours: float(actuator[theirs])
                for ours, theirs in _ACTUATOR_PARAMETER_KEYS.items()
            }
        )
        actuator_parameters_list.append(
            (
                str(actuator["type_axis"]),
                bool(actuator["clockwise_axis_movement"]),
                [actuator["min_increment"], actuator["max_increment"]],
                parameters,
            )
        )
    log.info("Loading heliostat properties data complete.")
    return (
        heliostat_position,
        _to_4d_direction(facet_translation_vectors),
        _to_4d_direction(canting),
        kinematics_deviations,
        initial_orientation,
        actuator_parameters_list,
    )


def extract_paint_deflectometry_data(
    heliostat_deflectometry_path: pathlib.Path | str,
    number_of_facets: int,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Per-facet deflectometry point/normal clouds from a PAINT HDF5.

    Raises ``ImportError`` where ``h5py`` is not installed.
    """
    import h5py

    log.info("Beginning extraction of deflectometry data from PAINT file.")
    points_list, normals_list = [], []
    with h5py.File(heliostat_deflectometry_path, "r") as file:
        for facet in range(number_of_facets):
            group = file[f"{FACET_KEY}{facet + 1}"]
            points_list.append(np.asarray(group[SURFACE_POINT_KEY][()], np.float32))
            normals_list.append(np.asarray(group[SURFACE_NORMAL_KEY][()], np.float32))
    log.info("Loading deflectometry data complete.")
    return points_list, normals_list


def _build_heliostat_configs(
    paths,
    power_plant_position: np.ndarray,
    number_of_nurbs_control_points: tuple[int, int],
    make_surface_config,
    **fit_kwargs: Any,
) -> tuple[HeliostatListConfig, PrototypeConfig]:
    """Shared per-heliostat processing; the prototype is the last heliostat's."""
    heliostat_config_list = []
    prototype: tuple | None = None
    for heliostat_index, file_tuple in enumerate(paths):
        (
            heliostat_position,
            facet_translation_vectors,
            canting,
            kinematics_deviations,
            initial_orientation,
            actuator_parameters_list,
        ) = extract_paint_heliostat_properties(
            pathlib.Path(file_tuple[1]), power_plant_position
        )
        surface_config = make_surface_config(
            file_tuple,
            facet_translation_vectors,
            canting,
            number_of_nurbs_control_points,
            **fit_kwargs,
        )
        kinematics_config = KinematicsConfig(
            kinematics_type=constants.rigid_body_key,
            initial_orientation=initial_orientation,
            deviations=kinematics_deviations,
        )
        actuator_list = [
            ActuatorConfig(
                actuator_key=f"{constants.heliostat_actuator_key}_{index}",
                actuator_type=actuator_type,
                clockwise_axis_movement=clockwise,
                min_max_motor_positions=np.asarray(min_max),
                parameters=parameters,
            )
            for index, (actuator_type, clockwise, min_max, parameters) in enumerate(
                actuator_parameters_list
            )
        ]
        heliostat_config_list.append(
            HeliostatConfig(
                name=str(file_tuple[0]),
                heliostat_id=heliostat_index,
                position=heliostat_position,
                surface=surface_config,
                kinematics=kinematics_config,
                actuators=ActuatorListConfig(actuator_list=actuator_list),
            )
        )
        prototype = (surface_config, kinematics_config, actuator_list)

    if prototype is None:
        raise ValueError("No heliostats could be processed from the given paths.")
    surface_prototype, kinematics_prototype, actuator_prototype = prototype
    prototype_config = PrototypeConfig(
        surface_prototype=SurfaceConfig(facet_list=surface_prototype.facet_list),
        kinematics_prototype=kinematics_prototype,
        actuators_prototype=ActuatorListConfig(actuator_list=actuator_prototype),
    )
    return (
        HeliostatListConfig(heliostat_list=heliostat_config_list),
        prototype_config,
    )


def extract_paint_heliostats_ideal_surface(
    paths: list[tuple[str, pathlib.Path]],
    power_plant_position: np.ndarray,
    number_of_nurbs_control_points: tuple[int, int] = (10, 10),
) -> tuple[HeliostatListConfig, PrototypeConfig]:
    """Heliostats with planar (ideal) NURBS surfaces."""

    def make_surface(file_tuple, translations, canting, control_points, **_):
        return SurfaceGenerator(
            number_of_control_points=control_points
        ).generate_ideal_surface_config(
            facet_translation_vectors=translations, canting=canting
        )

    return _build_heliostat_configs(
        paths, power_plant_position, number_of_nurbs_control_points, make_surface
    )


def extract_paint_heliostats_fitted_surface(
    paths: list[tuple[str, pathlib.Path, pathlib.Path]],
    power_plant_position: np.ndarray,
    number_of_nurbs_control_points: tuple[int, int] = (10, 10),
    initial_learning_rate: float = 1e-3,
    deflectometry_step_size: int = 100,
    nurbs_fit_method: str = constants.fit_nurbs_from_normals,
    nurbs_fit_tolerance: float = 1e-10,
    nurbs_fit_max_epoch: int = 400,
    device: torch.device | str = "cuda",
) -> tuple[HeliostatListConfig, PrototypeConfig]:
    """Heliostats with NURBS surfaces fitted to deflectometry data on ``device``."""

    def make_surface(file_tuple, translations, canting, control_points, **_):
        points_list, normals_list = extract_paint_deflectometry_data(
            pathlib.Path(file_tuple[2]), translations.shape[0]
        )
        return SurfaceGenerator(
            number_of_control_points=control_points
        ).generate_fitted_surface_config(
            heliostat_name=str(file_tuple[0]),
            facet_translation_vectors=translations,
            canting=canting,
            surface_points_with_facets_list=points_list,
            surface_normals_with_facets_list=normals_list,
            initial_learning_rate=initial_learning_rate,
            deflectometry_step_size=deflectometry_step_size,
            fit_method=nurbs_fit_method,
            tolerance=nurbs_fit_tolerance,
            max_epoch=nurbs_fit_max_epoch,
            device=device,
        )

    return _build_heliostat_configs(
        paths, power_plant_position, number_of_nurbs_control_points, make_surface
    )


def extract_paint_heliostats_mixed_surface(
    paths,
    power_plant_position: np.ndarray,
    number_of_nurbs_control_points: tuple[int, int] = (10, 10),
    **fit_kwargs: Any,
) -> tuple[HeliostatListConfig, PrototypeConfig]:
    """Fitted surfaces where deflectometry exists, ideal otherwise.

    ``fit_kwargs`` (``device`` among them) go to
    :func:`extract_paint_heliostats_fitted_surface`.
    """
    fitted_paths = [p for p in paths if len(p) == 3 and p[2] is not None]
    ideal_paths = [p for p in paths if not (len(p) == 3 and p[2] is not None)]

    heliostat_lists = []
    prototype_config = None
    if ideal_paths:
        ideal_list, prototype_config = extract_paint_heliostats_ideal_surface(
            ideal_paths, power_plant_position, number_of_nurbs_control_points
        )
        heliostat_lists.extend(ideal_list.heliostat_list)
    if fitted_paths:
        fitted_list, fitted_prototype = extract_paint_heliostats_fitted_surface(
            fitted_paths,
            power_plant_position,
            number_of_nurbs_control_points,
            **fit_kwargs,
        )
        heliostat_lists.extend(fitted_list.heliostat_list)
        if prototype_config is None:
            prototype_config = fitted_prototype
    if prototype_config is None:
        raise ValueError("No heliostats could be processed from the given paths.")
    return HeliostatListConfig(heliostat_list=heliostat_lists), prototype_config


def build_heliostat_data_mapping(
    base_path: str | pathlib.Path,
    heliostat_names: list[str],
    number_of_measurements: int,
    image_variant: str,
    randomize: bool = True,
    seed: int = 42,
) -> list[tuple[str, list[pathlib.Path], list[pathlib.Path]]]:
    """Collect calibration property/image path pairs per heliostat.

    With ``randomize`` each heliostat's property files are shuffled by
    Python's ``random.Random(seed)``, as in the JAX package, so both give
    the same order.
    """
    base = pathlib.Path(base_path)
    heliostat_map = []
    for name in heliostat_names:
        calibration_dir = base / name / SAVE_CALIBRATION
        if not calibration_dir.exists():
            log.warning("Calibration directory for %s not found.", name)
            continue
        property_files = list(
            calibration_dir.glob(f"*{CALIBRATION_PROPERTIES_IDENTIFIER}")
        )
        if randomize:
            random.Random(seed).shuffle(property_files)
        else:
            property_files.sort()
        properties, images = [], []
        for property_file in property_files:
            id_str = property_file.stem.split("-")[0]
            image_file = calibration_dir / f"{id_str}-{image_variant}.png"
            if image_file.exists():
                properties.append(property_file)
                images.append(image_file)
                if len(properties) == number_of_measurements:
                    break
        if len(properties) < number_of_measurements:
            log.warning(
                "%s has only %d valid measurements (needed %d).",
                name,
                len(properties),
                number_of_measurements,
            )
        if properties and images:
            heliostat_map.append((name, properties, images))
    return heliostat_map

"""Scenario-authoring configuration schema.

Counterpart of ``artist_tpu/util/config.py``: dataclasses that describe a
scenario (power plant, tower target areas, light sources, heliostats with
their surface, kinematics and actuator parameters), numpy-backed, each
serialising to the nested dict that
:mod:`artist_tpu_torch.scenario.h5_generator` writes to a scenario HDF5
file, keyed by :mod:`artist_tpu_torch.util.constants`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from artist_tpu_torch.util import constants


@dataclass
class PowerPlantConfig:
    """Power plant location in WGS84 (lat, lon, alt)."""

    power_plant_position: np.ndarray  # [3] float64

    def create_power_plant_dict(self) -> dict[str, Any]:
        return {constants.power_plant_position: np.asarray(self.power_plant_position, dtype=np.float64)}


@dataclass
class TargetAreaPlanarConfig:
    """One planar tower target area."""

    target_area_key: str
    center: np.ndarray  # [4]
    normal_vector: np.ndarray  # [4]
    plane_e: float
    plane_u: float

    def create_target_area_dict(self) -> dict[str, Any]:
        return {
            constants.target_area_position_center: np.asarray(self.center, dtype=np.float32),
            constants.target_area_normal_vector: np.asarray(self.normal_vector, dtype=np.float32),
            constants.target_area_plane_e: float(self.plane_e),
            constants.target_area_plane_u: float(self.plane_u),
        }


@dataclass
class TargetAreaCylindricalConfig:
    """One cylindrical tower target area (e.g. a convex receiver)."""

    target_area_key: str
    center: np.ndarray  # [4]
    axis: np.ndarray  # [4]
    normal_vector: np.ndarray  # [4]
    radius: float
    height: float
    opening_angle: float

    def create_target_area_dict(self) -> dict[str, Any]:
        return {
            constants.target_area_cylinder_center: np.asarray(self.center, dtype=np.float32),
            constants.target_area_cylinder_axis: np.asarray(self.axis, dtype=np.float32),
            constants.target_area_cylinder_normal: np.asarray(self.normal_vector, dtype=np.float32),
            constants.target_area_cylinder_radius: float(self.radius),
            constants.target_area_cylinder_height: float(self.height),
            constants.target_area_cylinder_opening_angle: float(self.opening_angle),
        }


@dataclass
class TargetAreaListConfig:
    """All target areas of a scenario, split by geometry type."""

    planar_target_area_list: list[TargetAreaPlanarConfig] = field(default_factory=list)
    cylindrical_target_area_list: list[TargetAreaCylindricalConfig] = field(default_factory=list)


@dataclass
class LightSourceConfig:
    """One light source (sun)."""

    light_source_key: str
    light_source_type: str = constants.sun_key
    number_of_rays: int = 200
    distribution_type: str = constants.light_source_distribution_is_normal
    mean: float = 0.0
    covariance: float = 4.3681e-06

    def create_light_source_dict(self) -> dict[str, Any]:
        return {
            constants.light_source_type: self.light_source_type,
            constants.light_source_number_of_rays: int(self.number_of_rays),
            constants.light_source_distribution_parameters: {
                constants.light_source_distribution_type: self.distribution_type,
                constants.light_source_mean: float(self.mean),
                constants.light_source_covariance: float(self.covariance),
            },
        }


@dataclass
class LightSourceListConfig:
    light_source_list: list[LightSourceConfig] = field(default_factory=list)


@dataclass
class FacetConfig:
    """NURBS facet: control points, degrees, canting, translation."""

    facet_key: str
    control_points: np.ndarray  # [Cu, Cv, 3]
    degrees: np.ndarray  # [2] int
    translation_vector: np.ndarray  # [4]
    canting: np.ndarray  # [2, 4]

    def create_facet_dict(self) -> dict[str, Any]:
        return {
            constants.facet_control_points: np.asarray(self.control_points, dtype=np.float32),
            constants.facet_degrees: np.asarray(self.degrees, dtype=np.int64),
            constants.facets_translation_vector: np.asarray(self.translation_vector, dtype=np.float32),
            constants.facets_canting: np.asarray(self.canting, dtype=np.float32),
        }


@dataclass
class SurfaceConfig:
    """Heliostat surface: list of facets."""

    facet_list: list[FacetConfig]

    def create_surface_dict(self) -> dict[str, Any]:
        return {
            constants.facets_key: {
                f.facet_key if f.facet_key else f"facet_{i + 1}": f.create_facet_dict()
                for i, f in enumerate(self.facet_list)
            }
        }


@dataclass
class KinematicsDeviations:
    """Rigid-body kinematics deviations (9 translations + 4 tilts)."""

    first_joint_translation_e: float = 0.0
    first_joint_translation_n: float = 0.0
    first_joint_translation_u: float = 0.0
    first_joint_tilt_n: float = 0.0
    first_joint_tilt_u: float = 0.0
    second_joint_translation_e: float = 0.0
    second_joint_translation_n: float = 0.0
    second_joint_translation_u: float = 0.0
    second_joint_tilt_e: float = 0.0
    second_joint_tilt_n: float = 0.0
    concentrator_translation_e: float = 0.0
    concentrator_translation_n: float = 0.0
    concentrator_translation_u: float = 0.0

    def create_kinematics_deviations_dict(self) -> dict[str, Any]:
        return {
            constants.first_joint_translation_e: float(self.first_joint_translation_e),
            constants.first_joint_translation_n: float(self.first_joint_translation_n),
            constants.first_joint_translation_u: float(self.first_joint_translation_u),
            constants.first_joint_tilt_n: float(self.first_joint_tilt_n),
            constants.first_joint_tilt_u: float(self.first_joint_tilt_u),
            constants.second_joint_translation_e: float(self.second_joint_translation_e),
            constants.second_joint_translation_n: float(self.second_joint_translation_n),
            constants.second_joint_translation_u: float(self.second_joint_translation_u),
            constants.second_joint_tilt_e: float(self.second_joint_tilt_e),
            constants.second_joint_tilt_n: float(self.second_joint_tilt_n),
            constants.concentrator_translation_e: float(self.concentrator_translation_e),
            constants.concentrator_translation_n: float(self.concentrator_translation_n),
            constants.concentrator_translation_u: float(self.concentrator_translation_u),
        }


@dataclass
class KinematicsConfig:
    """Kinematics type + initial orientation + deviations."""

    kinematics_type: str = constants.rigid_body_key
    initial_orientation: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0, 0.0], dtype=np.float32)
    )
    deviations: KinematicsDeviations = field(default_factory=KinematicsDeviations)

    def create_kinematics_dict(self) -> dict[str, Any]:
        return {
            constants.kinematics_type: self.kinematics_type,
            constants.kinematics_initial_orientation: np.asarray(
                self.initial_orientation, dtype=np.float32
            ),
            constants.kinematics_deviations: self.deviations.create_kinematics_deviations_dict(),
        }


@dataclass
class ActuatorParameters:
    """Per-actuator scalar parameters (linear actuator geometry)."""

    increment: float = 0.0
    initial_stroke_length: float = 0.0
    offset: float = 0.0
    pivot_radius: float = 0.0
    initial_angle: float = 0.0

    def create_actuator_parameters_dict(self) -> dict[str, Any]:
        return {
            constants.actuator_increment: float(self.increment),
            constants.actuator_initial_stroke_length: float(self.initial_stroke_length),
            constants.actuator_offset: float(self.offset),
            constants.actuator_pivot_radius: float(self.pivot_radius),
            constants.actuator_initial_angle: float(self.initial_angle),
        }


@dataclass
class ActuatorConfig:
    """One actuator: type, direction, motor range, parameters."""

    actuator_key: str
    actuator_type: str = constants.linear_actuator_key
    clockwise_axis_movement: bool = False
    min_max_motor_positions: np.ndarray = field(
        default_factory=lambda: np.array([0, 100000], dtype=np.int64)
    )
    parameters: ActuatorParameters | None = None

    def create_actuator_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            constants.actuator_type_key: self.actuator_type,
            constants.actuator_clockwise_axis_movement: bool(self.clockwise_axis_movement),
            constants.actuator_min_max_motor_positions: np.asarray(
                self.min_max_motor_positions, dtype=np.int64
            ),
        }
        if self.parameters is not None:
            out[constants.actuator_parameters_key] = (
                self.parameters.create_actuator_parameters_dict()
            )
        return out


@dataclass
class ActuatorListConfig:
    actuator_list: list[ActuatorConfig] = field(default_factory=list)

    def create_actuator_list_dict(self) -> dict[str, Any]:
        return {
            a.actuator_key if a.actuator_key else f"actuator_{i}": a.create_actuator_dict()
            for i, a in enumerate(self.actuator_list)
        }


@dataclass
class PrototypeConfig:
    """Scenario prototypes: surface, kinematics, actuators."""

    surface_prototype: SurfaceConfig
    kinematics_prototype: KinematicsConfig
    actuators_prototype: ActuatorListConfig

    def create_prototype_dict(self) -> dict[str, Any]:
        return {
            constants.surface_prototype_key: self.surface_prototype.create_surface_dict(),
            constants.kinematics_prototype_key: self.kinematics_prototype.create_kinematics_dict(),
            constants.actuators_prototype_key: self.actuators_prototype.create_actuator_list_dict(),
        }


# Prototype aliases: a prototype has the schema of its parent class.
SurfacePrototypeConfig = SurfaceConfig
KinematicsPrototypeConfig = KinematicsConfig
ActuatorPrototypeConfig = ActuatorListConfig


@dataclass
class HeliostatConfig:
    """One heliostat: position + optional individual surface/kinematics/actuators."""

    name: str
    heliostat_id: int
    position: np.ndarray  # [4]
    surface: SurfaceConfig | None = None
    kinematics: KinematicsConfig | None = None
    actuators: ActuatorListConfig | None = None

    def create_heliostat_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            constants.heliostat_id: int(self.heliostat_id),
            constants.heliostat_position: np.asarray(self.position, dtype=np.float32),
        }
        if self.surface is not None:
            out[constants.heliostat_surface_key] = self.surface.create_surface_dict()
        if self.kinematics is not None:
            out[constants.heliostat_kinematics_key] = self.kinematics.create_kinematics_dict()
        if self.actuators is not None:
            out[constants.heliostat_actuator_key] = self.actuators.create_actuator_list_dict()
        return out


@dataclass
class HeliostatListConfig:
    heliostat_list: list[HeliostatConfig] = field(default_factory=list)

"""Synthetic scenario and calibration data for the benchmark step, the chip smoke run and tests.

Counterpart of ``make_synthetic_scenario``, ``split_into_groups`` and
``SyntheticCalibrationParser`` in ``artist_tpu/scenario/synthetic.py``: a
physically plausible solar-tower field built in memory (no HDF5) - heliostats
on a grid south of a planar receiver, AA39-like linear actuators and 4-facet
canted surfaces (parameter values of the PAINT Juelich single-heliostat test
scenario) -, the same field split into several groups, and deterministic
focal-spot bitmaps to reconstruct surfaces from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from artist_tpu_torch.field.heliostat_group import HeliostatGroupState
from artist_tpu_torch.io.calibration import CalibrationData
from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.nurbs import (
    create_nurbs_evaluation_grid,
    create_planar_nurbs_control_points,
    evaluate_nurbs_surfaces,
)
from artist_tpu_torch.scenario.scenario import Scenario
from artist_tpu_torch.scene.sun import Sun
from artist_tpu_torch.util import constants


def _facet_layout() -> tuple[np.ndarray, np.ndarray]:
    """Canting vectors and facet translations of a 4-facet 3.2 x 2.56 m
    concentrator (AA39-like values)."""
    half_e, half_n = 0.8025, 0.6375
    cant_u_e, cant_u_n = 4.98e-3, 3.15e-3
    canting = np.zeros((4, 2, 4), dtype=np.float32)
    translations = np.zeros((4, 4), dtype=np.float32)
    for i, (sign_e, sign_n) in enumerate([(-1, 1), (1, 1), (-1, -1), (1, -1)]):
        canting[i, 0] = [half_e, 0.0, -sign_e * cant_u_e, 0.0]
        canting[i, 1] = [0.0, half_n, -sign_n * cant_u_n, 0.0]
        translations[i] = [sign_e * 0.8075, sign_n * 0.6425, 0.0402, 0.0]
    return canting, translations


def _actuator_parameters(actuator_type: str, num: int) -> tuple[np.ndarray, np.ndarray]:
    """Packed (non-optimizable, optimizable) actuator parameters."""
    if actuator_type == constants.linear_actuator_key:
        non_optimizable = np.zeros((num, 7, 2), dtype=np.float32)
        non_optimizable[:, 0] = constants.linear_actuator_int
        non_optimizable[:, 1] = [0.0, 1.0]  # clockwise flags
        non_optimizable[:, 2] = 0.0  # min motor position
        non_optimizable[:, 3] = [68745.0, 75308.0]  # max motor positions
        non_optimizable[:, 4] = 154166.67  # increment
        non_optimizable[:, 5] = [0.335308, 0.340771]  # offset
        non_optimizable[:, 6] = [0.338095, 0.3191]  # pivot radius
        optimizable = np.zeros((num, 2, 2), dtype=np.float32)
        optimizable[:, 0] = [0.039009538 - np.pi / 2, 0.9439222]  # initial angle
        optimizable[:, 1] = [0.07741279, 0.077522285]  # initial stroke length
    elif actuator_type == constants.ideal_actuator_key:
        non_optimizable = np.zeros((num, 4, 2), dtype=np.float32)
        non_optimizable[:, 0] = constants.ideal_actuator_int
        non_optimizable[:, 2] = -2.0 * np.pi
        non_optimizable[:, 3] = 2.0 * np.pi
        optimizable = np.zeros((0, 0), dtype=np.float32)
    else:
        raise ValueError(f"Unknown actuator type: {actuator_type}")
    return non_optimizable, optimizable


def make_synthetic_scenario(
    number_of_heliostats: int = 100,
    number_of_control_points_per_facet: tuple[int, int] = (7, 7),
    number_of_surface_points_per_facet: tuple[int, int] = (50, 50),
    number_of_rays: int = 32,
    actuator_type: str = constants.linear_actuator_key,
    device: torch.device | str = "cuda",
) -> Scenario:
    """Build a synthetic field with one planar receiver and one group.

    Parameters
    ----------
    number_of_heliostats : int
        Field size; heliostats are laid out on a grid south of the tower.
    number_of_control_points_per_facet, number_of_surface_points_per_facet :
        NURBS resolution.
    number_of_rays : int
        Sun rays per surface point.
    actuator_type : str
        "linear" (AA39-like lead screws) or "ideal".
    device : torch.device | str
        Device of every tensor in the scenario.
    """
    num = number_of_heliostats
    columns = max(1, int(np.ceil(np.sqrt(num))))
    grid_e = (np.arange(num) % columns - (columns - 1) / 2) * 8.0
    grid_n = (np.arange(num) // columns) * 12.0 + 25.0
    positions = np.stack(
        [grid_e, grid_n, np.full(num, 1.7), np.ones(num)], axis=1
    ).astype(np.float32)
    non_optimizable, optimizable = _actuator_parameters(actuator_type, num)

    def tensor(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    canting_one, translations_one = _facet_layout()
    canting = tensor(canting_one).expand(num, 4, 2, 4).contiguous()
    facet_translations = tensor(translations_one).expand(num, 4, 4).contiguous()
    control_points = create_planar_nurbs_control_points(
        number_of_control_points_per_facet, canting
    )

    points, normals = evaluate_nurbs_surfaces(
        control_points[:1],
        (3, 3),
        create_nurbs_evaluation_grid(number_of_surface_points_per_facet, device=device),
        canting=canting[:1],
        facet_translations=facet_translations[:1],
    )
    surface_points = points.reshape(1, -1, 4).expand(num, -1, -1).contiguous()
    surface_normals = normals.reshape(1, -1, 4).expand(num, -1, -1).contiguous()

    group = HeliostatGroupState(
        positions=tensor(positions),
        surface_points=surface_points,
        surface_normals=surface_normals,
        canting=canting,
        facet_translations=facet_translations,
        nurbs_control_points=control_points,
        initial_orientations=tensor([0.0, -1.0, 0.0, 0.0]).expand(num, 4).contiguous(),
        translation_deviations=torch.zeros((num, 9), device=device),
        rotation_deviations=torch.zeros((num, 4), device=device),
        actuator_non_optimizable=tensor(non_optimizable),
        actuator_optimizable=tensor(optimizable),
        motor_positions=torch.zeros((num, 2), device=device),
        names=tuple(f"H{i:04d}" for i in range(num)),
        kinematics_type=constants.rigid_body_key,
        actuator_type=actuator_type,
        nurbs_degrees=(3, 3),
    )

    tower = SolarTower(
        planar_centers=tensor([[0.0, -3.0, 45.0, 1.0]]),
        planar_normals=tensor([[0.0, 1.0, 0.0, 0.0]]),
        planar_dimensions=tensor([[10.0, 10.0]]),
        cylindrical_centers=torch.zeros((0, 4), device=device),
        cylindrical_axes=torch.zeros((0, 4), device=device),
        cylindrical_normals=torch.zeros((0, 4), device=device),
        cylindrical_radii=torch.zeros((0,), device=device),
        cylindrical_heights=torch.zeros((0,), device=device),
        cylindrical_opening_angles=torch.zeros((0,), device=device),
        planar_names=("receiver",),
        cylindrical_names=(),
    )

    return Scenario(
        power_plant_position=np.array([50.91342112259258, 6.387824755874856, 87.0]),
        solar_tower=tower,
        light_sources=[Sun(number_of_rays=number_of_rays)],
        heliostat_groups=[group],
        heliostat_group_names=[f"{constants.rigid_body_key}_{actuator_type}"],
    )


def split_into_groups(scenario: Scenario, number_of_groups: int) -> Scenario:
    """A single-group scenario split into ``number_of_groups`` contiguous groups of
    equal size (views of its tensors), for multi-group runs and tests."""
    if len(scenario.heliostat_groups) != 1:
        raise ValueError("split_into_groups expects a single-group scenario")
    group = scenario.heliostat_groups[0]
    total = group.number_of_heliostats
    if total % number_of_groups:
        raise ValueError(f"{total} heliostats do not split evenly into {number_of_groups} groups")
    size = total // number_of_groups
    groups = []
    for start in range(0, total, size):
        replacements = {}
        for field in dataclasses.fields(group):
            value = getattr(group, field.name)
            if (isinstance(value, torch.Tensor) and value.ndim >= 1 and value.shape[0] == total) or (
                field.name == "names"
            ):
                replacements[field.name] = value[start : start + size]
        groups.append(group.replace(**replacements))
    return Scenario(
        power_plant_position=scenario.power_plant_position,
        solar_tower=scenario.solar_tower,
        light_sources=scenario.light_sources,
        heliostat_groups=groups,
        heliostat_group_names=[f"{scenario.heliostat_group_names[0]}_{i}" for i in range(number_of_groups)],
    )


class SyntheticCalibrationParser:
    """In-memory calibration data (no files) for tests and dry runs.

    Implements the ``parse_data_for_reconstruction`` protocol of the PAINT
    calibration parser with Gaussian focal spots whose centres come from
    ``numpy.random.RandomState(seed)``, so the JAX package's parser of the
    same name gives the same arrays bit for bit. Every sample looks from
    the south horizon (``[0, 1, 0, 0]``) at target 0.
    """

    def __init__(self, samples_per_heliostat: int = 2, seed: int = 7):
        self.samples_per_heliostat = samples_per_heliostat
        self.seed = seed

    def parse_data_for_reconstruction(
        self,
        heliostat_data_mapping,
        heliostat_names,
        target_name_to_index,
        power_plant_position,
        bitmap_resolution,
    ) -> CalibrationData:
        num = len(heliostat_names)
        total = num * self.samples_per_heliostat
        width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
        yy, xx = np.mgrid[0:height, 0:width]
        rng = np.random.RandomState(self.seed)
        centers = rng.uniform(0.3, 0.7, size=(total, 2))
        flux = np.exp(
            -(
                (xx[None] / width - centers[:, :1, None]) ** 2
                + (yy[None] / height - centers[:, 1:, None]) ** 2
            )
            / 0.02
        ).astype(np.float32)
        return CalibrationData(
            flux_measured=flux,
            focal_spots=np.tile(np.array([0.0, -3.0, 45.0, 1.0], np.float32), (total, 1)),
            incident_ray_directions=np.tile(np.array([0.0, 1.0, 0.0, 0.0], np.float32), (total, 1)),
            motor_positions=np.full((total, 2), 30000.0, np.float32),
            active_heliostats_mask=np.full(num, self.samples_per_heliostat, np.int32),
            target_area_indices=np.zeros(total, np.int32),
        )

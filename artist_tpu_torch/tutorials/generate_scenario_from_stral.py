"""Tutorial 00b: a scenario from a STRAL deflectometry export, its NURBS fitted on the card.

Counterpart of ``tutorials/00_generate_scenario_from_stral.py``::

    python -m artist_tpu_torch.tutorials.generate_scenario_from_stral --stral FILE.binp --output scenario.h5 \\
        [--device cuda]

:func:`stral_scenario_generator` reads the ``.binp`` file, fits the NURBS
control points to the measured normals on ``device`` and returns the generator
of a one-heliostat scenario; the command writes it to an HDF5 file (needs
``h5py``).
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from artist_tpu_torch.io.stral import extract_stral_deflectometry_data
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.scenario.surface_generator import SurfaceGenerator
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.config import (
    ActuatorConfig,
    ActuatorListConfig,
    ActuatorParameters,
    HeliostatConfig,
    HeliostatListConfig,
    KinematicsConfig,
    LightSourceConfig,
    LightSourceListConfig,
    PowerPlantConfig,
    PrototypeConfig,
    TargetAreaPlanarConfig,
)
from artist_tpu_torch.util.logging_utils import set_logger_config

CONTROL_POINTS = (10, 10)
DEFLECTOMETRY_STEP = 100
NUMBER_OF_RAYS = 100


def stral_actuators() -> ActuatorListConfig:
    """Two AA39-like linear actuators, the second turning clockwise."""
    return ActuatorListConfig(
        actuator_list=[
            ActuatorConfig(
                actuator_key=f"actuator_{i}",
                actuator_type=constants.linear_actuator_key,
                clockwise_axis_movement=bool(i),
                min_max_motor_positions=np.array([0, 70000]),
                parameters=ActuatorParameters(
                    increment=154166.67,
                    initial_stroke_length=0.075,
                    offset=0.34,
                    pivot_radius=0.32,
                    initial_angle=0.5,
                ),
            )
            for i in range(2)
        ]
    )


def stral_scenario_generator(
    stral_file: pathlib.Path | str,
    scenario_path: pathlib.Path | str,
    number_of_control_points: tuple[int, int] = CONTROL_POINTS,
    max_epoch: int = 400,
    device: torch.device | str = "cuda",
) -> H5ScenarioGenerator:
    """The generator of the tutorial's scenario: the STRAL heliostat, its surface fitted
    to the measured normals (every :data:`DEFLECTOMETRY_STEP`-th point, at most
    ``max_epoch`` Adam epochs) on ``device``, 10 m east and 30 m north of a receiver
    8 m x 7 m at 45 m; its file is ``scenario_path``."""
    facet_translations, canting, points, normals = extract_stral_deflectometry_data(stral_file)
    surface_config = SurfaceGenerator(number_of_control_points=number_of_control_points).generate_fitted_surface_config(
        heliostat_name="heliostat_1",
        facet_translation_vectors=facet_translations,
        canting=canting,
        surface_points_with_facets_list=points,
        surface_normals_with_facets_list=normals,
        deflectometry_step_size=DEFLECTOMETRY_STEP,
        fit_method=constants.fit_nurbs_from_normals,
        max_epoch=max_epoch,
        device=device,
    )
    return H5ScenarioGenerator(
        file_path=scenario_path,
        power_plant_config=PowerPlantConfig(power_plant_position=np.array([50.91342, 6.38782, 87.0])),
        target_area_list_planar_config=[
            TargetAreaPlanarConfig(
                target_area_key="receiver",
                center=np.array([0.0, -3.0, 45.0, 1.0]),
                normal_vector=np.array([0.0, 1.0, 0.0, 0.0]),
                plane_e=8.0,
                plane_u=7.0,
            )
        ],
        target_area_list_cylindrical_config=[],
        light_source_list_config=LightSourceListConfig(
            light_source_list=[LightSourceConfig(light_source_key="sun_1", number_of_rays=NUMBER_OF_RAYS)]
        ),
        heliostat_list_config=HeliostatListConfig(
            heliostat_list=[
                HeliostatConfig(name="heliostat_1", heliostat_id=1, position=np.array([10.0, 30.0, 1.7, 1.0]))
            ]
        ),
        prototype_config=PrototypeConfig(
            surface_prototype=surface_config,
            kinematics_prototype=KinematicsConfig(),
            actuators_prototype=stral_actuators(),
        ),
    )


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stral", required=True, type=pathlib.Path, help="STRAL .binp deflectometry export")
    parser.add_argument("--output", required=True, type=pathlib.Path, help="scenario HDF5 file to write")
    parser.add_argument("--device", default="cuda", help="torch device of the fit (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    args.output.parent.mkdir(parents=True, exist_ok=True)
    path = stral_scenario_generator(args.stral, args.output, device=args.device).generate_scenario()
    print(f"Scenario written to {path}.")
    return path


if __name__ == "__main__":
    main()

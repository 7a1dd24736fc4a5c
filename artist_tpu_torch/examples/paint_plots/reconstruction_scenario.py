"""The scenario of the kinematics reconstruction: every viable heliostat on an ideal surface.

Counterpart of ``examples/paint_plots/reconstruction_scenario.py``: the tower of the
PAINT tower-measurement file and the viable heliostats (the list that
``reconstruction_generate_viable_heliostats_list`` wrote) on ideal (planar NURBS)
surfaces, one sun of 10 rays a point with the normal distribution's covariance
4.3681e-06. :func:`reconstruction_scenario_generator` builds the configs;
:func:`reconstruction_scenario` loads them onto a device from the scenario image in
memory, and the command writes them to ``<scenarios_dir>/reconstruction.h5`` (needs
``h5py``)::

    python -m artist_tpu_torch.examples.paint_plots.reconstruction_scenario \\
        [--config C] [--data_dir D] [--tower_file_name T] [--results_dir R] [--scenarios_dir S]
"""

from __future__ import annotations

import pathlib

import torch

from artist_tpu_torch.examples.paint_plots._config import load_config
from artist_tpu_torch.examples.paint_plots.reconstruction_generate_viable_heliostats_list import (
    read_viable_heliostats,
)
from artist_tpu_torch.io.paint_scenario_parser import (
    extract_paint_heliostats_ideal_surface,
    extract_paint_tower_measurements,
)
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_image
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.config import LightSourceConfig, LightSourceListConfig
from artist_tpu_torch.util.logging_utils import set_logger_config

SCENARIO_FILE = "reconstruction.h5"
NUMBER_OF_RAYS = 10
SUN_COVARIANCE = 4.3681e-06
# The reconstruction loads the scenario at 5 x 5 points a facet
# (reconstruction_generate_results.py:83-85).
SURFACE_POINTS = (5, 5)


def sun_config(number_of_rays: int = NUMBER_OF_RAYS) -> LightSourceListConfig:
    """The example's sun: ``number_of_rays`` rays a point, normally distributed."""
    return LightSourceListConfig(
        light_source_list=[
            LightSourceConfig(
                light_source_key="sun",
                light_source_type=constants.sun_key,
                number_of_rays=number_of_rays,
                distribution_type=constants.light_source_distribution_is_normal,
                mean=0.0,
                covariance=SUN_COVARIANCE,
            )
        ]
    )


def reconstruction_scenario_generator(
    scenario_path: pathlib.Path | str,
    tower_file: pathlib.Path | str,
    heliostat_files_list: list[tuple[str, pathlib.Path]],
) -> H5ScenarioGenerator:
    """The generator of the reconstruction scenario: the tower of ``tower_file`` and the
    heliostats ``(name, properties file)`` on ideal surfaces; its file ``scenario_path``."""
    power_plant, planar_targets, cylindrical_targets = extract_paint_tower_measurements(tower_file)
    heliostats, prototype = extract_paint_heliostats_ideal_surface(
        paths=heliostat_files_list, power_plant_position=power_plant.power_plant_position
    )
    return H5ScenarioGenerator(
        file_path=scenario_path,
        power_plant_config=power_plant,
        target_area_list_planar_config=planar_targets,
        target_area_list_cylindrical_config=cylindrical_targets,
        light_source_list_config=sun_config(),
        prototype_config=prototype,
        heliostat_list_config=heliostats,
    )


def reconstruction_scenario(
    tower_file: pathlib.Path | str,
    heliostat_files_list: list[tuple[str, pathlib.Path]],
    surface_points: tuple[int, int] = SURFACE_POINTS,
    device: torch.device | str = "cuda",
) -> Scenario:
    """The reconstruction scenario on ``device`` at ``surface_points`` a facet, loaded from
    its image in memory (no file)."""
    generator = reconstruction_scenario_generator(SCENARIO_FILE, tower_file, heliostat_files_list)
    return load_scenario_from_image(generator.scenario_image(), surface_points, device=device)


def heliostat_files(viable: list[dict]) -> list[tuple[str, pathlib.Path]]:
    """The ``(name, properties file)`` of each entry of the viable list."""
    return [(item["name"], pathlib.Path(item["properties"])) for item in viable]


def main(argv: list[str] | None = None) -> pathlib.Path:
    args = load_config(
        ["data_dir", "tower_file_name", "results_dir", "scenarios_dir"], description=__doc__.splitlines()[0], argv=argv
    )
    set_logger_config()
    viable = read_viable_heliostats(args.results_dir)
    args.scenarios_dir.mkdir(parents=True, exist_ok=True)
    path = reconstruction_scenario_generator(
        args.scenarios_dir / SCENARIO_FILE, args.data_dir / args.tower_file_name, heliostat_files(viable)
    ).generate_scenario()
    print(f"Reconstruction scenario saved to {path}")
    return path


if __name__ == "__main__":
    main()

"""Tutorial 00a: a scenario from PAINT tower-measurement and heliostat-properties files.

Counterpart of ``tutorials/00_generate_scenario_from_paint.py``::

    python -m artist_tpu_torch.tutorials.generate_scenario_from_paint --tower TOWER.json \\
        --heliostat AA39=AA39-heliostat-properties.json [--heliostat ...] --output scenario.h5

:func:`paint_scenario_generator` parses the JSON files into the scenario's
configs; the command writes them to an HDF5 file (needs ``h5py``), and
``load_scenario_from_image(generator.scenario_image())`` loads them without one.
"""

from __future__ import annotations

import argparse
import pathlib

from artist_tpu_torch.io.paint_scenario_parser import (
    extract_paint_heliostats_ideal_surface,
    extract_paint_tower_measurements,
)
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.util.config import LightSourceConfig, LightSourceListConfig
from artist_tpu_torch.util.logging_utils import set_logger_config

NUMBER_OF_RAYS = 100
CONTROL_POINTS = (7, 7)


def paint_scenario_generator(
    tower_file: pathlib.Path | str,
    heliostat_files: list[tuple[str, pathlib.Path]],
    scenario_path: pathlib.Path | str,
    number_of_rays: int = NUMBER_OF_RAYS,
    number_of_control_points: tuple[int, int] = CONTROL_POINTS,
) -> H5ScenarioGenerator:
    """The generator of a scenario with the tower's target areas and the heliostats
    ``(name, properties file)`` on ideal (planar NURBS) surfaces, one sun of
    ``number_of_rays`` rays a point; its file is ``scenario_path``."""
    power_plant, planar_targets, cylindrical_targets = extract_paint_tower_measurements(tower_file)
    heliostats, prototype = extract_paint_heliostats_ideal_surface(
        paths=heliostat_files,
        power_plant_position=power_plant.power_plant_position,
        number_of_nurbs_control_points=number_of_control_points,
    )
    return H5ScenarioGenerator(
        file_path=scenario_path,
        power_plant_config=power_plant,
        target_area_list_planar_config=planar_targets,
        target_area_list_cylindrical_config=cylindrical_targets,
        light_source_list_config=LightSourceListConfig(
            light_source_list=[LightSourceConfig(light_source_key="sun_1", number_of_rays=number_of_rays)]
        ),
        heliostat_list_config=heliostats,
        prototype_config=prototype,
    )


def heliostat_file(argument: str) -> tuple[str, pathlib.Path]:
    name, _, path = argument.partition("=")
    if not path:
        raise argparse.ArgumentTypeError(f"expected NAME=PATH, got {argument!r}")
    return name, pathlib.Path(path)


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tower", required=True, type=pathlib.Path, help="PAINT tower-measurements JSON")
    parser.add_argument("--heliostat", required=True, action="append", type=heliostat_file,
                        help="NAME=PATH of a PAINT heliostat-properties JSON (repeatable)")
    parser.add_argument("--output", required=True, type=pathlib.Path, help="scenario HDF5 file to write")
    args = parser.parse_args(argv)
    set_logger_config()
    args.output.parent.mkdir(parents=True, exist_ok=True)
    path = paint_scenario_generator(args.tower, args.heliostat, args.output).generate_scenario()
    print(f"Scenario written to {path}.")
    return path


if __name__ == "__main__":
    main()

"""The field-optimization example's scenario, from PAINT tower-measurement and heliostat-properties files.

Counterpart of ``examples/field_optimizations/generate_scenarios.py``: one
ideal-surface scenario of the configured heliostats::

    python -m artist_tpu_torch.examples.field_optimizations.generate_scenarios [config.yaml] [--data-dir DIR]

:func:`load_config` reads the YAML file with PyYAML (imported there) or takes a
dict; :func:`scenario_generator` builds the configs, which
:func:`generate_scenario` writes to an HDF5 file (``h5py``) and
``load_scenario_from_image(scenario_generator(config).scenario_image())`` loads
without one.
"""

from __future__ import annotations

import argparse
import copy
import pathlib

from artist_tpu_torch.io.paint_scenario_parser import (
    extract_paint_heliostats_ideal_surface,
    extract_paint_tower_measurements,
)
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.util.config import LightSourceConfig, LightSourceListConfig
from artist_tpu_torch.util.logging_utils import set_logger_config

CONFIG = pathlib.Path(__file__).with_name("config.yaml")
SCENARIO_FILE = "field_optimization_scenario.h5"


def load_config(source: dict | pathlib.Path | str | None = None, data_dir: pathlib.Path | str | None = None) -> dict:
    """The example's configuration: a copy of the dict ``source``, or the YAML file
    ``source`` (by default this package's ``config.yaml``), with ``data_dir`` set
    where it is given."""
    if isinstance(source, dict):
        config = copy.deepcopy(source)
    else:
        import yaml

        with open(CONFIG if source is None else source) as handle:
            config = yaml.safe_load(handle)
    if data_dir is not None:
        config["data_dir"] = str(data_dir)
    return config


def data_directory(config: dict) -> pathlib.Path:
    """The configuration's ``data_dir``; ``ValueError`` where it names none."""
    if not config.get("data_dir"):
        raise ValueError("the configuration names no data_dir: set it in the file or pass --data-dir")
    return pathlib.Path(config["data_dir"])


def config_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The arguments every script of the example takes: the YAML file and ``--data-dir``."""
    parser.add_argument("config", nargs="?", type=pathlib.Path, help=f"configuration YAML (default: {CONFIG.name})")
    parser.add_argument("--data-dir", type=pathlib.Path, help="PAINT data directory (overrides data_dir)")
    return parser


def scenario_generator(config: dict, scenario_path: pathlib.Path | str | None = None) -> H5ScenarioGenerator:
    """The generator of the example's scenario: the tower of ``tower_file_name`` and the
    ``heliostats`` (``<name>-heliostat-properties.json`` in ``data_dir``) on ideal
    surfaces of the surface stage's ``number_of_control_points``, one sun of its
    ``number_of_rays``; its file ``scenario_path`` (default: ``scenarios_dir`` /
    :data:`SCENARIO_FILE`)."""
    data_dir = data_directory(config)
    surface = config["surface_reconstruction_optimization_configuration"]
    power_plant, planar_targets, cylindrical_targets = extract_paint_tower_measurements(
        data_dir / config["tower_file_name"]
    )
    control_points = int(surface["number_of_control_points"])
    heliostats, prototype = extract_paint_heliostats_ideal_surface(
        paths=[(name, data_dir / f"{name}-heliostat-properties.json") for name in config["heliostats"]],
        power_plant_position=power_plant.power_plant_position,
        number_of_nurbs_control_points=(control_points, control_points),
    )
    if scenario_path is None:
        scenario_path = pathlib.Path(config["scenarios_dir"]) / SCENARIO_FILE
    return H5ScenarioGenerator(
        file_path=scenario_path,
        power_plant_config=power_plant,
        target_area_list_planar_config=planar_targets,
        target_area_list_cylindrical_config=cylindrical_targets,
        light_source_list_config=LightSourceListConfig(
            light_source_list=[
                LightSourceConfig(light_source_key="sun_1", number_of_rays=int(surface["number_of_rays"]))
            ]
        ),
        heliostat_list_config=heliostats,
        prototype_config=prototype,
    )


def generate_scenario(config: dict) -> pathlib.Path:
    """Write the example's scenario file under ``scenarios_dir`` (needs ``h5py``) and
    return its path."""
    pathlib.Path(config["scenarios_dir"]).mkdir(parents=True, exist_ok=True)
    return scenario_generator(config).generate_scenario()


def main(argv: list[str] | None = None) -> pathlib.Path:
    args = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0])).parse_args(argv)
    set_logger_config()
    path = generate_scenario(load_config(args.config, args.data_dir))
    print(f"scenario written to {path}")
    return path


if __name__ == "__main__":
    main()

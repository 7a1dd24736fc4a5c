"""The two scenarios of the flux-prediction plot: ideal surfaces and deflectometry-fitted ones.

Counterpart of ``examples/paint_plots/flux_prediction_scenario.py``. For the
heliostats of ``heliostats_for_raytracing``, :func:`flux_prediction_scenario_generator`
builds the configs of one scenario: planar NURBS surfaces of 20 x 20 control points,
or NURBS of 20 x 20 control points fitted to each heliostat's latest deflectometry
measurement (every 100th point, the normals, tolerance 1e-10, 400 epochs, on
``device``), with one sun of 10 rays a point. The fitted surfaces may also be given
in memory (``fitted_surfaces``). The command writes ``flux_prediction_ideal.h5`` and
``flux_prediction_fitted.h5`` under ``scenarios_dir`` (``h5py``), the second only
where every heliostat has a deflectometry file, as the JAX script does::

    python -m artist_tpu_torch.examples.paint_plots.flux_prediction_scenario \\
        [--config C] [--data_dir D] [--tower_file_name T] [--scenarios_dir S] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import torch

from artist_tpu_torch.examples.paint_plots._config import load_config
from artist_tpu_torch.examples.paint_plots.reconstruction_scenario import sun_config
from artist_tpu_torch.io.paint_scenario_parser import (
    extract_paint_heliostats_fitted_surface,
    extract_paint_heliostats_ideal_surface,
    extract_paint_tower_measurements,
)
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.config import PrototypeConfig, SurfaceConfig
from artist_tpu_torch.util.logging_utils import set_logger_config

CONTROL_POINTS = (20, 20)
# The fit of flux_prediction_scenario.py:104-111.
FIT = dict(
    deflectometry_step_size=100,
    nurbs_fit_method=constants.fit_nurbs_from_normals,
    nurbs_fit_tolerance=1e-10,
    nurbs_fit_max_epoch=400,
)
SCENARIOS = {"ideal": False, "fitted": True}


def scenario_file(stem: str) -> str:
    return f"flux_prediction_{stem}.h5"


def properties_path(data_directory: pathlib.Path, name: str) -> pathlib.Path:
    return pathlib.Path(data_directory) / name / "Properties" / f"{name}-heliostat-properties.json"


def find_latest_deflectometry_file(heliostat_name: str, data_directory: pathlib.Path) -> pathlib.Path:
    """The heliostat's latest deflectometry file (the last of its timestamped names)."""
    search_path = pathlib.Path(data_directory) / heliostat_name / "Deflectometry"
    candidates = sorted(search_path.glob(f"{heliostat_name}-filled-*.h5"))
    if not candidates:
        raise FileNotFoundError(f"No deflectometry file found for {heliostat_name} in {search_path}.")
    return candidates[-1]


def with_surfaces(configs, surfaces: dict[str, SurfaceConfig]):
    """Heliostat configs and prototype with each heliostat's surface taken from
    ``surfaces`` by name; the prototype's is the last heliostat's, as the PAINT parser
    makes it."""
    heliostats, prototype = configs
    heliostats = dataclasses.replace(
        heliostats,
        heliostat_list=[dataclasses.replace(h, surface=surfaces[h.name]) for h in heliostats.heliostat_list],
    )
    last = heliostats.heliostat_list[-1].surface
    return heliostats, PrototypeConfig(
        surface_prototype=SurfaceConfig(facet_list=last.facet_list),
        kinematics_prototype=prototype.kinematics_prototype,
        actuators_prototype=prototype.actuators_prototype,
    )


def flux_prediction_scenario_generator(
    scenario_path: pathlib.Path | str,
    tower_file: pathlib.Path | str,
    data_directory: pathlib.Path | str,
    heliostat_names: list[str],
    use_deflectometry: bool,
    fitted_surfaces: dict[str, SurfaceConfig] | None = None,
    device: torch.device | str = "cuda",
) -> H5ScenarioGenerator:
    """The generator of one flux-prediction scenario of ``heliostat_names`` (their
    properties under ``data_directory``): ideal surfaces, or with ``use_deflectometry``
    the ``fitted_surfaces`` given, or surfaces fitted on ``device`` to each heliostat's
    latest deflectometry file (``FileNotFoundError`` where one has none)."""
    data_directory = pathlib.Path(data_directory)
    power_plant, planar_targets, cylindrical_targets = extract_paint_tower_measurements(tower_file)
    position = power_plant.power_plant_position
    paths = [(name, properties_path(data_directory, name)) for name in heliostat_names]
    if use_deflectometry and fitted_surfaces is None:
        heliostats, prototype = extract_paint_heliostats_fitted_surface(
            paths=[(name, path, find_latest_deflectometry_file(name, data_directory)) for name, path in paths],
            power_plant_position=position,
            number_of_nurbs_control_points=CONTROL_POINTS,
            device=device,
            **FIT,
        )
    else:
        heliostats, prototype = extract_paint_heliostats_ideal_surface(
            paths=paths, power_plant_position=position, number_of_nurbs_control_points=CONTROL_POINTS
        )
        if use_deflectometry:
            heliostats, prototype = with_surfaces((heliostats, prototype), fitted_surfaces)
    return H5ScenarioGenerator(
        file_path=scenario_path,
        power_plant_config=power_plant,
        target_area_list_planar_config=planar_targets,
        target_area_list_cylindrical_config=cylindrical_targets,
        light_source_list_config=sun_config(),
        prototype_config=prototype,
        heliostat_list_config=heliostats,
    )


def generate_flux_prediction_scenarios(
    scenarios_dir: pathlib.Path, tower_file: pathlib.Path, data_directory: pathlib.Path, heliostat_names: list[str],
    device: torch.device | str = "cuda",
) -> list[pathlib.Path]:
    """Write both scenario files under ``scenarios_dir``; the fitted one is skipped, with
    a message, where a heliostat has no deflectometry file. Returns the files written."""
    pathlib.Path(scenarios_dir).mkdir(parents=True, exist_ok=True)
    written = []
    for stem, use_deflectometry in SCENARIOS.items():
        try:
            generator = flux_prediction_scenario_generator(
                pathlib.Path(scenarios_dir) / scenario_file(stem), tower_file, data_directory, heliostat_names,
                use_deflectometry, device=device,
            )
        except FileNotFoundError as error:
            if not use_deflectometry:
                raise
            print(f"Skipping fitted scenario: {error}")
            continue
        written.append(generator.generate_scenario())
        print(f"Scenario saved to {written[-1]}")
    return written


def main(argv: list[str] | None = None) -> list[pathlib.Path]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="where the fits run: cuda (default) or cpu")
    args = load_config(
        ["data_dir", "tower_file_name", "scenarios_dir", "heliostats_for_raytracing"],
        description=__doc__.splitlines()[0], argv=argv, parser=parser,
    )
    set_logger_config()
    heliostat_names = sorted((args.heliostats_for_raytracing or {}).keys())
    if not heliostat_names:
        raise ValueError(
            "heliostats_for_raytracing is empty; configure at least one heliostat -> calibration-measurement mapping."
        )
    return generate_flux_prediction_scenarios(
        args.scenarios_dir, args.data_dir / args.tower_file_name, args.data_dir, heliostat_names, args.device
    )


if __name__ == "__main__":
    main()

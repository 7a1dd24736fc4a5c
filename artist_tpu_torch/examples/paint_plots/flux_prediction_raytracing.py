"""The flux predictions of the PAINT plot: each heliostat aimed at its measured focal spot and traced.

Counterpart of ``examples/paint_plots/flux_prediction_raytracing.py``. In each
scenario (ideal, fitted) every heliostat of ``heliostats_for_raytracing`` is aligned
to the focal spot its calibration measurement recorded, under that measurement's
sun, and traced with 1,000 rays a point onto 256 x 256; the predicted bitmap and the
measured flux image are stored under ``<name>/<ideal|fitted>`` and ``<name>/utis``
in ``<results_dir>/flux_prediction_results.npz``::

    python -m artist_tpu_torch.examples.paint_plots.flux_prediction_raytracing \\
        [--config C] [--data_dir D] [--scenarios_dir S] [--results_dir R] [--device cuda]

The command reads the scenario files (``h5py``) and the PAINT files (the flux
images need ``PIL``). :func:`generate_flux_images` takes a scenario in memory and
any calibration parser: the measured image is the one the parser reads with the
calibration, not a second read of the PNG. The sun's distortions come from a
``torch.Generator`` seeded with 7, where the JAX script takes ``jax.random.PRNGKey(7)``.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from artist_tpu_torch.examples.paint_plots._config import load_config
from artist_tpu_torch.examples.paint_plots.flux_prediction_scenario import SCENARIOS, scenario_file
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.io.calibration import PaintCalibrationDataParser
from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.scene.sun import Sun
from artist_tpu_torch.util.logging_utils import set_logger_config

RESOLUTION = (256, 256)
NUMBER_OF_RAYS = 1000
SEED = 7
MEASURED_KEY = "utis"
RESULTS_FILE = "flux_prediction_results.npz"


def calibration_mapping(heliostats: dict[str, int], data_directory: pathlib.Path) -> list:
    """The PAINT parser's mapping of each heliostat's one measurement: its
    calibration-properties file and its flux image."""
    root = pathlib.Path(data_directory)
    return [
        (
            name,
            [root / name / "Calibration" / f"{measurement}-calibration-properties.json"],
            [root / name / "Calibration" / f"{measurement}-flux.png"],
        )
        for name, measurement in heliostats.items()
    ]


def prediction_sun(scenario: Scenario) -> Sun:
    """The scenario's sun distribution at :data:`NUMBER_OF_RAYS` rays a point."""
    return Sun(
        number_of_rays=NUMBER_OF_RAYS, distribution_parameters=scenario.light_sources[0].distribution_parameters
    )


@torch.no_grad()
def generate_flux_images(
    scenario: Scenario,
    heliostats: dict[str, int],
    data_directory: pathlib.Path | str | None,
    results: dict[str, np.ndarray],
    result_key: str,
    data_parser=None,
    sun=None,
    device: torch.device | str = "cuda",
) -> dict[str, np.ndarray]:
    """Align each heliostat of ``heliostats`` (name -> measurement id) to its measured
    focal spot, trace it, and store its bitmap ``[256, 256]`` under
    ``<name>/<result_key>`` in ``results`` and its measured image under ``<name>/utis``
    (where not there yet). ``data_parser`` (default: the PAINT parser over
    ``data_directory``) gives the calibration; ``sun`` (default:
    :func:`prediction_sun`) the distortions. Returns ``results``."""
    scenario.to(device)
    sun = sun or prediction_sun(scenario)
    parser = data_parser or PaintCalibrationDataParser()
    mapping = calibration_mapping(heliostats, data_directory) if data_directory is not None else []
    tower = scenario.solar_tower
    for group in scenario.heliostat_groups:
        calibration = parser.parse_data_for_reconstruction(
            heliostat_data_mapping=mapping,
            heliostat_names=group.names,
            target_name_to_index=tower.target_name_to_index,
            power_plant_position=scenario.power_plant_position,
            bitmap_resolution=RESOLUTION,
        )
        mask = np.asarray(calibration.active_heliostats_mask)
        if mask.sum() == 0:
            continue
        group_device = group.positions.device
        active_indices = torch.as_tensor(hg.active_indices_from_mask(mask), dtype=torch.long, device=group_device)
        active = hg.gather_active(group, active_indices)
        incident = torch.as_tensor(calibration.incident_ray_directions, dtype=torch.float32, device=group_device)
        targets = torch.as_tensor(calibration.target_area_indices, dtype=torch.long, device=group_device)
        # The measured focal spots are the aim points (flux_prediction_raytracing.py:98-106).
        aim_points = torch.as_tensor(calibration.focal_spots, dtype=torch.float32, device=group_device)
        points, normals = hg.align_surfaces_with_incident_ray_directions(active, aim_points, incident)[:2]
        generator = torch.Generator(device=group_device).manual_seed(SEED)
        distortions_u, distortions_e = sun.get_distortions(generator, points.shape[1], active_indices.shape[0])
        flux = trace_rays(
            tower, points, normals, incident, targets, distortions_u, distortions_e,
            config=RenderConfig(bitmap_resolution=RESOLUTION),
        )[0].cpu().numpy()
        names = [name for name, count in zip(group.names, mask) for _ in range(int(count))]
        for sample, name in enumerate(names):
            results[f"{name}/{result_key}"] = flux[sample]
            results.setdefault(f"{name}/{MEASURED_KEY}", np.asarray(calibration.flux_measured[sample]))
    return results


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = load_config(
        ["data_dir", "scenarios_dir", "results_dir", "heliostats_for_raytracing"],
        description=__doc__.splitlines()[0], argv=argv, parser=parser,
    )
    set_logger_config()
    heliostats = {name: int(measurement) for name, measurement in (args.heliostats_for_raytracing or {}).items()}
    if not heliostats:
        raise ValueError("heliostats_for_raytracing is empty.")
    args.results_dir.mkdir(parents=True, exist_ok=True)
    results_file = args.results_dir / RESULTS_FILE
    results: dict[str, np.ndarray] = dict(np.load(results_file)) if results_file.exists() else {}
    for stem in SCENARIOS:
        scenario_path = args.scenarios_dir / scenario_file(stem)
        if not scenario_path.exists():
            print(f"Skipping {stem}: {scenario_path} not found (run flux_prediction_scenario first).")
            continue
        scenario = load_scenario_from_hdf5(scenario_path, device=args.device)
        generate_flux_images(scenario, heliostats, args.data_dir, results, stem, device=args.device)
    np.savez(results_file, **results)
    print(f"Flux prediction results saved to {results_file}")
    return results_file


if __name__ == "__main__":
    main()

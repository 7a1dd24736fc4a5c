"""The kinematics reconstruction of the PAINT plot, run twice: on UTIS and on HeliOS centroids.

Counterpart of ``examples/paint_plots/reconstruction_generate_results.py``. For each
centroid-extraction method the raytracing-method ``KinematicsReconstructor`` runs on
a fresh copy of the scenario, its calibration parser reading at most 3 samples a
heliostat with that method's focal spots, under ``setup_distributed_environment``;
each heliostat's final focal-spot loss (m on the target) and its position are saved
to ``<results_dir>/kinematics_reconstruction_results.json`` under the JAX keys
(``UTIS``, ``HeliOS``, ``Position``)::

    python -m artist_tpu_torch.examples.paint_plots.reconstruction_generate_results \\
        [--config C] [--results_dir R] [--scenarios_dir S] [--max_epoch N] [--device cuda]

The command reads the scenario file (``h5py``) and the PAINT files (the flux
images need ``PIL``). :func:`generate_reconstruction_results` takes a scenario in
memory and any calibration parser.

Two faults of the JAX script are not copied:

- it writes ``max_epoch`` into its module-level configuration, so that a second
  call in one process inherits the cut; here each call builds its own
  (:func:`optimization_configuration`);
- its reconstruction holds each traced flux's centre of mass to the measured
  flux's, and never reads the centroids, so its UTIS and HeliOS runs are the same
  run. Here the focal-spot loss holds it to the measured focal spots, the centroids
  the parser read (``focal_spot_ground_truth="focal_spots"``); ``"flux"`` gives
  the JAX script's.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
from typing import Callable

import torch

from artist_tpu_torch.examples.paint_plots._config import load_config
from artist_tpu_torch.examples.paint_plots.reconstruction_generate_viable_heliostats_list import (
    read_viable_heliostats,
)
from artist_tpu_torch.examples.paint_plots.reconstruction_scenario import SCENARIO_FILE, SURFACE_POINTS
from artist_tpu_torch.io.calibration import PAINT_HELIOS_KEY, PAINT_UTIS_KEY, PaintCalibrationDataParser
from artist_tpu_torch.optim.kinematics_reconstructor import KinematicsReconstructor
from artist_tpu_torch.parallel import setup_distributed_environment
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import set_logger_config

UTIS_KEY = PAINT_UTIS_KEY
HELIOS_KEY = PAINT_HELIOS_KEY
CENTROIDS = (UTIS_KEY, HELIOS_KEY)
POSITION_KEY = "Position"
SAMPLE_LIMIT = 3
RESULTS_FILE = "kinematics_reconstruction_results.json"

# reconstruction_generate_results.py:50-65: the patience of 4000 epochs stops no run early.
OPTIMIZATION_CONFIGURATION = {
    constants.optimization: {
        constants.initial_learning_rate_rotation_deviation: 1e-4,
        constants.tolerance: 0.0,
        constants.max_epoch: 1000,
        constants.batch_size: 500,
        constants.log_step: 50,
        constants.early_stopping_delta: 1e-6,
        constants.early_stopping_patience: 4000,
        constants.early_stopping_window: 1000,
    },
    constants.scheduler: {
        constants.scheduler_type: constants.exponential,
        constants.gamma: 0.999,
    },
}


def optimization_configuration(max_epoch: int | None = None) -> dict:
    """A copy of :data:`OPTIMIZATION_CONFIGURATION`, its ``max_epoch`` set where given."""
    configuration = copy.deepcopy(OPTIMIZATION_CONFIGURATION)
    if max_epoch is not None:
        configuration[constants.optimization][constants.max_epoch] = int(max_epoch)
    return configuration


def paint_parser(centroid: str) -> PaintCalibrationDataParser:
    """The script's parser: at most :data:`SAMPLE_LIMIT` samples a heliostat, the focal
    spots of ``centroid``."""
    return PaintCalibrationDataParser(sample_limit=SAMPLE_LIMIT, centroid_extraction_method=centroid)


def generate_reconstruction_results(
    scenario: Scenario | Callable[[], Scenario],
    heliostat_data_mapping: list | None = None,
    max_epoch: int | None = None,
    device: torch.device | str = "cuda",
    data_parser: Callable[[str], object] = paint_parser,
    on_epoch: dict[str, Callable[[int, float], None]] | None = None,
    focal_spot_ground_truth: str = "focal_spots",
    details: dict | None = None,
) -> dict[str, dict]:
    """Reconstruct the kinematics once for each centroid method; return each heliostat's
    final focal-spot loss under ``UTIS`` and ``HeliOS`` and its position under
    ``Position``.

    ``scenario`` is copied for each run, or, where it is a function, called for a
    fresh one; each run moves it to ``device``. ``data_parser(centroid)`` gives the
    run's calibration parser (by default :func:`paint_parser`), which reads
    ``heliostat_data_mapping``. ``on_epoch`` maps a centroid to its run's callback.
    Where ``details`` is given, each run's group results (loss histories, the test
    split's losses) and reconstructed rotation deviations are put there, by centroid.
    """
    configuration = optimization_configuration(max_epoch)
    results: dict[str, dict] = {}
    for centroid in CENTROIDS:
        run_scenario = scenario() if callable(scenario) else copy.deepcopy(scenario)
        run_scenario.to(device)
        groups = run_scenario.heliostat_groups
        with setup_distributed_environment(number_of_heliostat_groups=len(groups), device=str(device)) as setup:
            reconstructor = KinematicsReconstructor(
                scenario=run_scenario,
                data={
                    constants.data_parser: data_parser(centroid),
                    constants.heliostat_data_mapping: heliostat_data_mapping or [],
                },
                optimization_configuration=configuration,
                reconstruction_method=constants.kinematics_reconstruction_raytracing,
                distributed_setup=setup,
                focal_spot_ground_truth=focal_spot_ground_truth,
            )
            per_heliostat_losses, group_results = reconstructor.reconstruct_kinematics(
                "focal_spot", on_epoch=(on_epoch or {}).get(centroid)
            )
        if details is not None:
            details[centroid] = dict(
                results=group_results, rotation_deviations=[g.rotation_deviations.cpu().numpy() for g in groups]
            )
        offset = 0
        for group in groups:
            positions = group.positions.cpu().numpy()
            for index, name in enumerate(group.names):
                entry = results.setdefault(name, {})
                entry[centroid] = float(per_heliostat_losses[offset + index])
                entry[POSITION_KEY] = positions[index].tolist()
            offset += group.number_of_heliostats
    return results


def heliostat_data_mapping(viable: list[dict]) -> list:
    """The parser's mapping of each entry of the viable list: (name, calibration files,
    flux images)."""
    return [
        (item["name"], [pathlib.Path(p) for p in item["calibrations"]], [pathlib.Path(p) for p in item["flux_images"]])
        for item in viable
    ]


def save_results(results: dict, results_dir: pathlib.Path) -> pathlib.Path:
    results_dir = pathlib.Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    path = results_dir / RESULTS_FILE
    with open(path, "w") as handle:
        json.dump(results, handle, indent=1)
    return path


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max_epoch", type=int, default=None, help="cut every run to this max_epoch")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = load_config(["results_dir", "scenarios_dir"], description=__doc__.splitlines()[0], argv=argv,
                       parser=parser)
    set_logger_config()
    viable = read_viable_heliostats(args.results_dir)
    scenario_path = args.scenarios_dir / SCENARIO_FILE
    if not scenario_path.exists():
        raise FileNotFoundError(
            f"The reconstruction scenario at {scenario_path} was not found; run reconstruction_scenario first."
        )
    results = generate_reconstruction_results(
        lambda: load_scenario_from_hdf5(scenario_path, SURFACE_POINTS, device=args.device),
        heliostat_data_mapping(viable),
        max_epoch=args.max_epoch,
        device=args.device,
    )
    path = save_results(results, args.results_dir)
    print(f"Reconstruction results saved to {path}")
    return path


if __name__ == "__main__":
    main()

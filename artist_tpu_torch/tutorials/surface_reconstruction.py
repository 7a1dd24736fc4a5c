"""Tutorial 03: NURBS surface reconstruction from measured flux images.

Counterpart of ``tutorials/03_surface_reconstruction.py``::

    python -m artist_tpu_torch.tutorials.surface_reconstruction --scenario PATH --field-data DIR [--device cuda]

The command reads the scenario (``h5py``) and the PAINT calibration data of
heliostat AA39 in ``DIR`` (``AA39-calibration-properties_<i>.json`` and
``AA39-flux-centered_<i>.png``, i = 1, 2, 3; the PNGs need ``PIL``).
:func:`reconstruct_surfaces` runs on any calibration parser, such as
``CalibrationDataParser`` over samples in memory.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from artist_tpu_torch.io.calibration import PaintCalibrationDataParser
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import set_logger_config

SURFACE_POINTS = (50, 50)
CONTROL_POINTS = (7, 7)
BITMAP = (256, 256)
HELIOSTAT = "AA39"
SAMPLES = (1, 2, 3)


def optimization_configuration() -> dict:
    """The tutorial's optimizer: rate 1e-4, 50 epochs, reduce-on-plateau, the energy
    constraint and both regularizers at 0.005."""
    return {
        constants.optimization: {
            constants.initial_learning_rate: 1e-4,
            constants.tolerance: 5e-4,
            constants.max_epoch: 50,
            constants.batch_size: 30,
            constants.log_step: 10,
            constants.early_stopping_delta: 1.0,
            constants.early_stopping_patience: 10,
            constants.early_stopping_window: 40,
        },
        constants.scheduler: {
            constants.scheduler_type: constants.reduce_on_plateau,
            constants.lr_min: 1e-6,
            constants.reduce_factor: 0.8,
            constants.patience: 10,
            constants.threshold: 1e-4,
            constants.cooldown: 5,
        },
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.energy_tolerance: 0.01,
            constants.weight_smoothness: 0.005,
            constants.weight_ideal_surface: 0.005,
        },
    }


def heliostat_data_mapping(field_data: pathlib.Path | str, heliostat: str = HELIOSTAT, samples=SAMPLES) -> list:
    """``[(heliostat, calibration-properties files, centred flux PNGs)]`` in ``field_data``."""
    field_data = pathlib.Path(field_data)
    return [
        (
            heliostat,
            [field_data / f"{heliostat}-calibration-properties_{i}.json" for i in samples],
            [field_data / f"{heliostat}-flux-centered_{i}.png" for i in samples],
        )
    ]


def reconstruct_surfaces(
    scenario: Scenario,
    data_parser,
    heliostat_data_mapping: list | None = None,
    configuration: dict | None = None,
    bitmap_resolution: tuple[int, int] = BITMAP,
    device: torch.device | str = "cuda",
    on_epoch=None,
    **options,
):
    """``SurfaceReconstructor.reconstruct_surfaces("kl_divergence")`` on ``scenario`` moved
    to ``device``, reading ``data_parser`` (over ``heliostat_data_mapping``) with the
    tutorial's :func:`optimization_configuration` unless ``configuration`` is given;
    ``options`` go to the reconstructor, ``on_epoch(epoch, loss)`` to its loop. Returns
    its final losses and group results."""
    reconstructor = SurfaceReconstructor(
        scenario=scenario.to(device),
        data={constants.data_parser: data_parser, constants.heliostat_data_mapping: heliostat_data_mapping or []},
        optimization_configuration=configuration or optimization_configuration(),
        bitmap_resolution=bitmap_resolution,
        **options,
    )
    return reconstructor.reconstruct_surfaces("kl_divergence", on_epoch=on_epoch)


def describe(results) -> list[str]:
    """The tutorial's printed lines, one a group."""
    lines = []
    for result in results:
        history = result.loss_history["total_loss"]
        lines.append(
            f"Group {result.group_index}: loss {history[0]:.4f} -> {history[-1]:.4f} over {len(history)} epochs; "
            f"test pixel loss {result.test_loss['test_loss_pixel']}"
        )
    return lines


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", required=True, help="scenario HDF5 file")
    parser.add_argument("--field-data", required=True, type=pathlib.Path, help="PAINT calibration files of AA39")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    scenario = load_scenario_from_hdf5(
        args.scenario,
        number_of_surface_points_per_facet=SURFACE_POINTS,
        change_number_of_control_points_per_facet=CONTROL_POINTS,
        device=args.device,
    )
    final_loss, results = reconstruct_surfaces(
        scenario, PaintCalibrationDataParser(), heliostat_data_mapping(args.field_data), device=args.device
    )
    print("\n".join(describe(results)))
    return final_loss, results


if __name__ == "__main__":
    main()

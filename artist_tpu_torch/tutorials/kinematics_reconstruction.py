"""Tutorial 04: kinematics calibration from calibration measurements.

Counterpart of ``tutorials/04_kinematics_reconstruction.py``, with the
``"alignment"`` method (no ray tracing in training)::

    python -m artist_tpu_torch.tutorials.kinematics_reconstruction --scenario PATH --field-data DIR [--device cuda]

The command reads the scenario (``h5py``) and the PAINT calibration data of
heliostat AA39 in ``DIR`` (the PNGs need ``PIL``).
:func:`reconstruct_kinematics` runs on any calibration parser.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from artist_tpu_torch.io.calibration import PaintCalibrationDataParser
from artist_tpu_torch.optim.kinematics_reconstructor import KinematicsReconstructor
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.tutorials.surface_reconstruction import heliostat_data_mapping
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import set_logger_config

SURFACE_POINTS = (25, 25)
BITMAP = (64, 64)


def optimization_configuration() -> dict:
    """The tutorial's optimizer: rotation-deviation rate 1e-4, 100 epochs, reduce-on-plateau."""
    return {
        constants.optimization: {
            constants.initial_learning_rate_rotation_deviation: 1e-4,
            constants.tolerance: 0.0005,
            constants.max_epoch: 100,
            constants.batch_size: 30,
            constants.log_step: 20,
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
    }


def reconstruct_kinematics(
    scenario: Scenario,
    data_parser,
    heliostat_data_mapping: list | None = None,
    configuration: dict | None = None,
    method: str = constants.kinematics_reconstruction_alignment,
    bitmap_resolution: tuple[int, int] = BITMAP,
    device: torch.device | str = "cuda",
    on_epoch=None,
    **options,
):
    """``KinematicsReconstructor.reconstruct_kinematics("angle")`` with ``method`` on
    ``scenario`` moved to ``device``; the tutorial's :func:`optimization_configuration`
    unless ``configuration`` is given; ``on_epoch(epoch, loss)`` goes to its loop. Returns its
    final losses and group results."""
    reconstructor = KinematicsReconstructor(
        scenario=scenario.to(device),
        data={constants.data_parser: data_parser, constants.heliostat_data_mapping: heliostat_data_mapping or []},
        optimization_configuration=configuration or optimization_configuration(),
        reconstruction_method=method,
        bitmap_resolution=bitmap_resolution,
        **options,
    )
    return reconstructor.reconstruct_kinematics("angle", on_epoch=on_epoch)


def describe(results) -> list[str]:
    """The tutorial's printed lines, one a group."""
    return [
        f"Group {result.group_index}: alignment loss {result.loss_history[0]:.6f} -> "
        f"{result.loss_history[-1]:.6f}; test focal spot loss {result.test_loss['focal_spot_loss']}"
        for result in results
    ]


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", required=True, help="scenario HDF5 file")
    parser.add_argument("--field-data", required=True, type=pathlib.Path, help="PAINT calibration files of AA39")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    scenario = load_scenario_from_hdf5(args.scenario, number_of_surface_points_per_facet=SURFACE_POINTS,
                                       device=args.device)
    final_loss, results = reconstruct_kinematics(
        scenario, PaintCalibrationDataParser(), heliostat_data_mapping(args.field_data), device=args.device
    )
    print("\n".join(describe(results)))
    return final_loss, results


if __name__ == "__main__":
    main()

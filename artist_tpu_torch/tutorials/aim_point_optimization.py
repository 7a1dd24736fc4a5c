"""Tutorial 05: field-level flux shaping by motor-position optimization.

Counterpart of ``tutorials/05_aim_point_optimization.py``: a trapezoid target
distribution on the receiver, every heliostat's motor positions optimized
jointly, blocking on (K = 16 candidates a heliostat)::

    python -m artist_tpu_torch.tutorials.aim_point_optimization --scenario PATH [--device cuda]

The scenario file is read with ``h5py``; :func:`optimize_aim_points` needs none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from artist_tpu_torch.flux.bitmap import trapezoid_distribution
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import set_logger_config

SURFACE_POINTS = (25, 25)
BITMAP = (256, 256)
DNI = 800.0
TRAPEZOID = (40, 80)  # slope and plateau widths, in pixels
SOUTH = (0.0, 1.0, 0.0, 0.0)


def optimization_configuration() -> dict:
    """The tutorial's optimizer: rate 1e-3, 40 epochs, reduce-on-plateau, every penalty
    weight 1, maximum flux density 1e6."""
    return {
        constants.optimization: {
            constants.initial_learning_rate: 1e-3,
            constants.tolerance: 0.0005,
            constants.max_epoch: 40,
            constants.batch_size: 50,
            constants.log_step: 10,
            constants.early_stopping_delta: 1.0,
            constants.early_stopping_patience: 10,
            constants.early_stopping_window: 40,
        },
        constants.scheduler: {
            constants.scheduler_type: constants.reduce_on_plateau,
            constants.lr_min: 1e-4,
            constants.reduce_factor: 0.9,
            constants.patience: 100,
            constants.threshold: 1e-3,
            constants.cooldown: 20,
        },
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.rho_local_flux: 1.0,
            constants.rho_intercept: 1.0,
            constants.max_flux_density: 1000000,
        },
    }


def trapezoid_ground_truth(resolution: tuple[int, int] = BITMAP, slope: int = TRAPEZOID[0],
                           plateau: int = TRAPEZOID[1]) -> np.ndarray:
    """``outer(trapezoid(height), trapezoid(width))``, ``[height, width]``."""
    horizontal = trapezoid_distribution(resolution[0], slope, plateau, device="cpu").numpy()
    vertical = trapezoid_distribution(resolution[1], slope, plateau, device="cpu").numpy()
    return np.outer(vertical, horizontal)


def optimize_aim_points(
    scenario: Scenario,
    configuration: dict | None = None,
    ground_truth: np.ndarray | None = None,
    dni: float = DNI,
    bitmap_resolution: tuple[int, int] = BITMAP,
    device: torch.device | str = "cuda",
    on_epoch=None,
    **options,
):
    """``AimPointOptimizer.optimize("kl_divergence")`` on ``scenario`` moved to ``device``,
    the sun in the south, target 0, the trapezoid ground truth by default; ``options``
    go to the optimizer, ``on_epoch(epoch, loss)`` to its loop. Returns its final loss,
    history, and intercept, on-target and blocking factors."""
    optimizer = AimPointOptimizer(
        scenario=scenario.to(device),
        optimization_configuration=configuration or optimization_configuration(),
        incident_ray_direction=list(SOUTH),
        target_area_index=0,
        ground_truth=trapezoid_ground_truth(bitmap_resolution) if ground_truth is None else ground_truth,
        dni=dni,
        bitmap_resolution=bitmap_resolution,
        **options,
    )
    return optimizer.optimize("kl_divergence", on_epoch=on_epoch)


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", required=True, help="scenario HDF5 file")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    scenario = load_scenario_from_hdf5(args.scenario, number_of_surface_points_per_facet=SURFACE_POINTS,
                                       device=args.device)
    result = optimize_aim_points(scenario, device=args.device)
    final_loss, history, intercepts, on_targets, blockings = result
    print(f"KL loss {history['total_loss'][0]:.4f} -> {history['total_loss'][-1]:.4f} "
          f"over {len(history['total_loss'])} epochs")
    print(f"Mean intercept factor: {float(intercepts.mean()):.3f}")
    for group in scenario.heliostat_groups:
        print(f"Optimized motor positions:\n{group.motor_positions.cpu().numpy()}")
    return result


if __name__ == "__main__":
    main()

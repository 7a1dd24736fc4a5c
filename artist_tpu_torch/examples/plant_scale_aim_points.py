"""Plant-scale aim-point optimization on one card.

Counterpart of ``examples/plant_scale_aim_points.py``: a Jülich-class synthetic
field (4,000 heliostats by default) optimized by :class:`AimPointOptimizer`
with

- ``heliostat_chunk``: the heliostat axis cut into checkpointed chunks
  (:mod:`artist_tpu_torch.parallel.microbatch`), so the backward keeps one
  chunk's aligned surfaces and per-ray tensors at a time;
- ``blocking_candidates=16``: the compacted blocking kernels, O(rays x K)
  instead of O(rays x field).

Blocking stays field-wide and exact across chunks: every chunk's 4-corner
primitives first, then each chunk traced against all of them.

Run small on the CPU::

    PLANT_HELIOSTATS=16 PLANT_CHUNK=8 PLANT_SURFACE_POINTS=5 \\
        python -m artist_tpu_torch.examples.plant_scale_aim_points --device cpu

Run at plant scale on the card (the defaults: 4,000 heliostats, chunks of 500,
2 rays a point, 50 x 50 points a facet x 4 facets, 10 epochs, 256 x 256)::

    python -m artist_tpu_torch.examples.plant_scale_aim_points
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from artist_tpu_torch.flux.bitmap import trapezoid_distribution
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import set_logger_config

HELIOSTATS = int(os.environ.get("PLANT_HELIOSTATS", 4000))
CHUNK = int(os.environ.get("PLANT_CHUNK", 500))
RAYS = int(os.environ.get("PLANT_RAYS", 2))
POINTS = int(os.environ.get("PLANT_SURFACE_POINTS", 50))
EPOCHS = int(os.environ.get("PLANT_EPOCHS", 10))
RESOLUTION = (256, 256)
CANDIDATES = 16


def configuration(epochs: int = EPOCHS) -> dict:
    """The example's optimizer: lr 1e-3, exponential decay 0.99, every penalty weight 1,
    maximum flux density 1e6; ``max_epoch`` = ``epochs`` (the loop runs epochs 0 to it)."""
    return {
        constants.optimization: {
            constants.initial_learning_rate: 1e-3,
            constants.tolerance: 0.0,
            constants.max_epoch: epochs,
            constants.batch_size: 100,
            constants.log_step: 1,
            constants.early_stopping_delta: 1.0,
            constants.early_stopping_patience: 50,
            constants.early_stopping_window: 50,
        },
        constants.scheduler: {constants.scheduler_type: constants.exponential, constants.gamma: 0.99},
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.rho_intercept: 1.0,
            constants.rho_local_flux: 1.0,
            constants.max_flux_density: 1e6,
        },
    }


def ground_truth(resolution: tuple[int, int] = RESOLUTION) -> np.ndarray:
    """The wanted flux: ``outer(trapezoid(height, 30, 60), trapezoid(width, 30, 60))``."""
    horizontal = trapezoid_distribution(resolution[0], 30, 60, device="cpu").numpy()
    vertical = trapezoid_distribution(resolution[1], 30, 60, device="cpu").numpy()
    return np.outer(vertical, horizontal)


def make_optimizer(
    heliostats: int = HELIOSTATS,
    chunk: int | None = CHUNK,
    rays: int = RAYS,
    points: int = POINTS,
    epochs: int = EPOCHS,
    device: str | torch.device = "cuda",
) -> AimPointOptimizer:
    """The example's field and optimizer; ``chunk`` is passed as ``heliostat_chunk`` when
    the field is larger (None: unchunked)."""
    scenario = make_synthetic_scenario(
        number_of_heliostats=heliostats,
        number_of_surface_points_per_facet=(points, points),
        number_of_rays=rays,
        device=torch.device(device),
    )
    return AimPointOptimizer(
        scenario=scenario,
        optimization_configuration=configuration(epochs),
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        target_area_index=0,
        ground_truth=ground_truth(),
        dni=1000.0,
        bitmap_resolution=RESOLUTION,
        blocking_candidates=CANDIDATES,
        heliostat_chunk=chunk if chunk and heliostats > chunk else None,
    )


def run(
    heliostats: int = HELIOSTATS,
    chunk: int | None = CHUNK,
    rays: int = RAYS,
    points: int = POINTS,
    epochs: int = EPOCHS,
    device: str | torch.device = "cuda",
) -> dict:
    """Build the field and run the optimization.

    Returns the optimizer, its outputs (final loss, history, intercept,
    on-target and blocking factors) and ``seconds``, the wall-clock time of
    :meth:`AimPointOptimizer.optimize` (the card synchronised before and after).
    """
    device = torch.device(device)
    optimizer = make_optimizer(heliostats, chunk, rays, points, epochs, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    final_loss, history, intercepts, on_targets, blockings = optimizer.optimize("kl_divergence")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(
        optimizer=optimizer,
        final_loss=final_loss,
        history=history,
        intercepts=intercepts,
        on_targets=on_targets,
        blockings=blockings,
        seconds=time.perf_counter() - start,
    )


def summary(heliostats: int, chunk: int | None, result: dict) -> str:
    """The example's printed line (the JAX example's)."""
    return (
        f"{heliostats} heliostats, chunk {chunk}: final loss {result['final_loss']:.4f}, "
        f"history {['%.4f' % value for value in result['history']['total_loss']]}, "
        f"mean intercept {float(result['intercepts'].mean()):.3f}, "
        f"mean blocking factor {float(result['blockings'].mean()):.4f}"
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    print(summary(HELIOSTATS, CHUNK, run(device=args.device)))


if __name__ == "__main__":
    main()

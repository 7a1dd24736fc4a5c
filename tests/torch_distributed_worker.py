"""One rank of the port's multi-process CPU tests (``tests/test_torch_distributed.py``).

Runs the three optimizers of ``artist_tpu_torch`` at the JAX package's worker size
(``tests/parallel/distributed_worker.py``: 4 heliostats, 6 x 6 control points and
4 x 4 surface points a facet, 4 rays a point, 32 x 32 bitmaps, max_epoch 2) and
pickles what they return, with the first objective gradient of each:

- the surface reconstructor on ``SyntheticCalibrationParser(2)`` data;
- the kinematics reconstructor, both methods, on samples cast from known
  rotation deviations (``chip_smoke.kinematics_calibration``, 4 a heliostat);
- the aim-point optimizer on 8 heliostats in rows 3 m apart under a 10 m
  receiver, where heliostats block each other's rays (also across the groups).

The field is one group, or split into ``--groups`` groups. Invoked as::

    python tests/torch_distributed_worker.py --output OUT.pkl --groups G
        [--coordinator HOST:PORT --num-processes N --process-id I]
        [--mesh-shape H R] [--checkpoint-dir DIR]

Without ``--coordinator`` it runs a world of one process. The tests import
:func:`run` to run the same in their own process.
"""

from __future__ import annotations

import argparse
import pathlib
import pickle
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer  # noqa: E402
from artist_tpu_torch.optim.kinematics_reconstructor import KinematicsReconstructor  # noqa: E402
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor  # noqa: E402
from artist_tpu_torch.parallel import (  # noqa: E402
    collectives,
    put_global,
    ray_sharding,
    setup_distributed_environment,
)
from artist_tpu_torch.parallel.mesh import fetch_global  # noqa: E402
from artist_tpu_torch.scenario.synthetic import (  # noqa: E402
    SyntheticCalibrationParser,
    make_synthetic_scenario,
    split_into_groups,
)
from artist_tpu_torch.util import constants  # noqa: E402

CPU = torch.device("cpu")
HELIOSTATS = 4
CONTROL_POINTS = (6, 6)
POINTS = (4, 4)
RAYS = 4
BITMAP = (32, 32)
MAX_EPOCH = 2
KINEMATICS_SAMPLES = 4
AIM_HELIOSTATS = 8
AIM_FIELD = dict(row_spacing=chip_smoke.DENSE_ROW_SPACING, columns=2, column_spacing=3.5, receiver_height=10.0)
KINEMATICS_METHODS = (constants.kinematics_reconstruction_raytracing, constants.kinematics_reconstruction_alignment)
TIMEOUT_SECONDS = 120.0


def _optimization(rate_key: str, rate: float) -> dict:
    return {
        rate_key: rate,
        constants.tolerance: 1e-9,
        constants.max_epoch: MAX_EPOCH,
        constants.batch_size: 8,
        constants.log_step: 0,
        constants.early_stopping_delta: 1.0,
        constants.early_stopping_patience: 5,
        constants.early_stopping_window: 40,
    }


SCHEDULER = {constants.scheduler_type: constants.exponential, constants.gamma: 0.99}
SURFACE_CONFIGURATION = {
    constants.optimization: _optimization(constants.initial_learning_rate, 1e-4),
    constants.scheduler: SCHEDULER,
    constants.constraints: {
        constants.rho_flux_integral: 1.0,
        constants.energy_tolerance: 0.01,
        constants.weight_smoothness: 0.005,
        constants.weight_ideal_surface: 0.005,
    },
}
KINEMATICS_CONFIGURATION = {
    constants.optimization: _optimization(constants.initial_learning_rate_rotation_deviation, 1e-4),
    constants.scheduler: SCHEDULER,
}
AIM_POINT_CONFIGURATION = {
    constants.optimization: _optimization(constants.initial_learning_rate, 1e-3),
    constants.scheduler: SCHEDULER,
    constants.constraints: {
        constants.rho_flux_integral: 1.0,
        constants.rho_intercept: 1.0,
        constants.rho_local_flux: 1.0,
        constants.max_flux_density: 1e6,
    },
}


def grouped(scenario, groups: int):
    return split_into_groups(scenario, groups) if groups > 1 else scenario


def surface_scenario(groups: int):
    scenario = make_synthetic_scenario(HELIOSTATS, CONTROL_POINTS, POINTS, RAYS, device=CPU)
    return grouped(scenario, groups)


def kinematics_data():
    """Samples cast from known rotation deviations: 4 a heliostat, each under its own sun."""
    size = dict(heliostats=HELIOSTATS, surface_points=POINTS, rays=RAYS, bitmap=BITMAP)
    known = chip_smoke.known_rotation_deviations(HELIOSTATS)
    return chip_smoke.kinematics_calibration(chip_smoke.kinematics_scenario(CPU, size), known, KINEMATICS_SAMPLES, BITMAP)


def aim_point_scenario(groups: int):
    return grouped(chip_smoke.aim_point_scenario(CPU, AIM_HELIOSTATS, POINTS, RAYS, **AIM_FIELD), groups)


def aim_point_ground_truth() -> np.ndarray:
    return chip_smoke.aim_point_ground_truth(BITMAP, CPU, slope=5, plateau=10).numpy()


def aim_point_optimizer(scenario, **options) -> AimPointOptimizer:
    return AimPointOptimizer(
        scenario=scenario,
        optimization_configuration=AIM_POINT_CONFIGURATION,
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        target_area_index=0,
        ground_truth=aim_point_ground_truth(),
        dni=1000.0,
        bitmap_resolution=BITMAP,
        **options,
    )


def aim_point_gradient(optimizer: AimPointOptimizer) -> dict[int, np.ndarray]:
    """The first epoch's gradient of each group's tanh parameters (every group's, on every rank)."""
    params, forward, loss_fn = optimizer.objective("kl_divergence")
    with torch.no_grad():
        flux, intercepts, _, _ = forward(params)
    zero = torch.zeros(())
    for param in params:
        param.requires_grad_(True)
    loss, _ = loss_fn(params, (torch.sum(flux), intercepts), (zero, zero, zero))
    loss.backward()
    owned = [g for g, motor in enumerate(optimizer.initial_motor_positions_all_groups) if motor is not None]
    gradients = {g: param.grad.numpy() for g, param in zip(owned, params)}
    return collectives.merge_group_outputs(optimizer.distributed_setup, gradients)


OPTIMIZERS = ("surface", *KINEMATICS_METHODS, "aim_point")


def run(setup, groups: int, checkpoint_dir=None, light_sources: dict | None = None, data=None,
        optimizers: tuple[str, ...] = OPTIMIZERS) -> dict:
    """The ``optimizers`` (``"surface"``, ``"raytracing"``, ``"alignment"``,
    ``"aim_point"``) on the field of ``groups`` groups under ``setup`` (None: no
    setup); ``light_sources`` replaces a scenario's sun by optimizer name, a function
    of the scenario; ``data`` are the kinematics samples (:func:`kinematics_data`).
    Returns numpy arrays and numbers by name."""
    light_sources = light_sources or {}
    checkpoints = {}
    if checkpoint_dir is not None:
        root = pathlib.Path(checkpoint_dir)
        checkpoints = {
            name: dict(checkpoint_dir=root if name != "alignment" else root / name, checkpoint_every=1)
            for name in ("surface", "raytracing", "alignment", "aim_point")
        }

    def lit(name: str, scenario):
        if name in light_sources:
            scenario.light_sources[0] = light_sources[name](scenario)
        return scenario

    out: dict = {}
    if "surface" in optimizers:
        out.update(run_surface(setup, groups, lit, checkpoints))
    data = kinematics_data() if data is None else data
    for method in KINEMATICS_METHODS:
        if method in optimizers:
            out.update(run_kinematics(setup, groups, lit, checkpoints, data, method))
    if "aim_point" in optimizers:
        out.update(run_aim_point(setup, groups, lit, checkpoints))
    return out


def run_surface(setup, groups: int, lit, checkpoints: dict) -> dict:
    """The surface reconstructor: its first gradients, losses, control points and surfaces."""
    out = {}
    scenario = lit("surface", surface_scenario(groups))
    surface = SurfaceReconstructor(
        scenario,
        {constants.data_parser: SyntheticCalibrationParser(samples_per_heliostat=2), constants.heliostat_data_mapping: []},
        SURFACE_CONFIGURATION,
        number_of_surface_points=POINTS,
        bitmap_resolution=BITMAP,
        distributed_setup=setup,
        **checkpoints.get("surface", {}),
    )
    for g, gradient in surface.single_step_gradients().items():
        out[f"surface_gradient_{g}"] = gradient["gradients"]
        out[f"surface_first_loss_{g}"] = gradient["loss"]
    final, results = surface.reconstruct_surfaces("kl_divergence")
    out["surface_final_loss"] = final
    out["surface_groups"] = [result.group_index for result in results]
    for result in results:
        out[f"surface_history_{result.group_index}"] = np.asarray(result.loss_history["total_loss"])
    for g, group in enumerate(scenario.heliostat_groups):
        out[f"surface_control_points_{g}"] = group.nurbs_control_points.numpy()
        out[f"surface_points_{g}"] = group.surface_points.numpy()
    return out


def run_kinematics(setup, groups: int, lit, checkpoints: dict, data, method: str) -> dict:
    """The kinematics reconstructor with ``method``: its first gradients, losses and deviations."""
    out = {}
    scenario = lit(method, surface_scenario(groups))
    kinematics = KinematicsReconstructor(
        scenario,
        {constants.data_parser: chip_smoke.CalibrationSamples(data), constants.heliostat_data_mapping: []},
        KINEMATICS_CONFIGURATION,
        reconstruction_method=method,
        bitmap_resolution=BITMAP,
        distributed_setup=setup,
        **checkpoints.get(method, {}),
    )
    for g, gradient in kinematics.single_step_gradients().items():
        out[f"{method}_gradient_{g}"] = gradient["gradients"]
    final, results = kinematics.reconstruct_kinematics()
    out[f"{method}_final_loss"] = final
    out[f"{method}_groups"] = [result.group_index for result in results]
    for result in results:
        out[f"{method}_history_{result.group_index}"] = np.asarray(result.loss_history)
    for g, group in enumerate(scenario.heliostat_groups):
        out[f"{method}_rotation_deviations_{g}"] = group.rotation_deviations.numpy()
    return out


def run_aim_point(setup, groups: int, lit, checkpoints: dict) -> dict:
    """The aim-point optimizer: its first gradient, losses, factors and motor positions."""
    out = {}
    gradients = aim_point_gradient(
        aim_point_optimizer(lit("aim_point", aim_point_scenario(groups)), distributed_setup=setup)
    )
    for g, gradient in gradients.items():
        out[f"aim_point_gradient_{g}"] = gradient
    scenario = lit("aim_point", aim_point_scenario(groups))
    loss, history, intercepts, on_targets, blockings = aim_point_optimizer(
        scenario, distributed_setup=setup, **checkpoints.get("aim_point", {})
    ).optimize("kl_divergence")
    out["aim_point_final_loss"] = np.float64(loss)
    for key, values in history.items():
        out[f"aim_point_history_{key}"] = np.asarray(values)
    out["aim_point_intercepts"] = intercepts.numpy()
    out["aim_point_on_targets"] = on_targets.numpy()
    out["aim_point_blockings"] = blockings.numpy()
    for g, group in enumerate(scenario.heliostat_groups):
        out[f"aim_point_motor_positions_{g}"] = group.motor_positions.numpy()
    return out


def exchanges(setup) -> dict:
    """The host collectives and a sharded round trip on this world: what each returns here."""
    rank = setup.rank
    tensor = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    sharding = ray_sharding(setup.mesh)
    local = put_global(tensor, sharding)
    collectives.barrier()
    return {
        "gathered_ranks": np.asarray(collectives.all_gather_object(rank)),
        "broadcast_from_last": np.asarray(collectives.broadcast_object(rank, setup.world_size - 1)),
        "minimum": collectives.all_reduce_min(np.asarray([rank, -rank], np.float64)),
        "sum": collectives.all_reduce_sum(np.asarray([rank, 1.0])),
        "local_shape": np.asarray(local.shape),
        "round_trip": fetch_global(local, sharding, tuple(tensor.shape)).numpy(),
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", required=True)
    parser.add_argument("--groups", type=int, required=True)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--mesh-shape", type=int, nargs=2, default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    args = parser.parse_args()
    torch.set_num_threads(2)
    with setup_distributed_environment(
        args.groups,
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        mesh_shape=tuple(args.mesh_shape) if args.mesh_shape else None,
        device="cpu",
        timeout=TIMEOUT_SECONDS,
    ) as setup:
        out = run(setup, args.groups, args.checkpoint_dir)
        out.update(rank=setup.rank, world_size=setup.world_size, is_nested=setup.is_nested)
        out.update({f"exchange_{key}": value for key, value in exchanges(setup).items()})
    with open(args.output, "wb") as handle:
        pickle.dump(out, handle)
    print(f"rank {args.process_id} done", flush=True)


if __name__ == "__main__":
    main()

"""The three field optimizations in sequence, kinematics -> surfaces -> aim points, from one configuration.

Counterpart of ``examples/field_optimizations/generate_results.py``: each stage
runs on the scenario the previous stage left (the surfaces are reconstructed
with the deviations the kinematics stage found, the aim points optimized on the
reconstructed surfaces) and saves its results under ``results_dir`` with the
JAX pipeline's file names and keys::

    python -m artist_tpu_torch.examples.field_optimizations.generate_results [config.yaml] \\
        [kinematics|surface|aim_point|all] [--data-dir DIR] [--device cuda]

The command reads the scenario file (``h5py``; written first from the PAINT
files where it is missing) and the PAINT calibration data (the PNGs need
``PIL``). :func:`run_pipeline` and the stage functions take a scenario in
memory and any calibration parser, such as ``CalibrationDataParser`` over
samples in memory.

Two settings of each stage's block are applied that the JAX pipeline reads but
does not apply: ``number_of_rays`` (the scenario's sun carries that many rays a
point for the stage) and ``sample_limit`` (the stage's parser reads at most that
many samples a heliostat). The JAX pipeline traces every stage with the sun's
rays from the scenario file and reads every sample up to
``maximum_number_of_measurements``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import pathlib

import numpy as np
import torch

from artist_tpu_torch.examples.field_optimizations.generate_scenarios import (
    SCENARIO_FILE,
    config_arguments,
    data_directory,
    generate_scenario,
    load_config,
)
from artist_tpu_torch.flux.bitmap import trapezoid_distribution
from artist_tpu_torch.io.calibration import PaintCalibrationDataParser
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
from artist_tpu_torch.optim.kinematics_reconstructor import KinematicsReconstructor
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.parallel import setup_distributed_environment
from artist_tpu_torch.scenario.scenario import Scenario, load_scenario_from_hdf5
from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import set_logger_config, set_runtime_logger, track_runtime

STAGES = ("kinematics", "surface", "aim_point")
AIM_POINT_BITMAP = (256, 256)
SOUTH = (0.0, 1.0, 0.0, 0.0)
OPTIMIZATION_KEYS = [
    "tolerance", "max_epoch", "batch_size", "log_step", "early_stopping_delta", "early_stopping_patience",
    "early_stopping_window",
]
SCHEDULER_KEYS = [
    "scheduler_type", "lr_min", "lr_max", "step_size_up", "reduce_factor", "patience", "threshold", "cooldown", "gamma",
]


def build_heliostat_data_mapping(config: dict) -> list:
    """Each configured heliostat's calibration files in ``data_dir`` by the naming
    convention (``<name>-calibration-properties_<i>.json``, ``<name>-flux-centered_<i>.png``),
    at most ``maximum_number_of_measurements``, the pairs whose PNG exists."""
    data_dir = data_directory(config)
    limit = int(config["maximum_number_of_measurements"])
    mapping = []
    for name in config["heliostats"]:
        properties = sorted(data_dir.glob(f"{name}-calibration-properties_*.json"))[:limit]
        fluxes = [data_dir / f"{name}-flux-centered_{p.stem.rsplit('_', 1)[-1]}.png" for p in properties]
        pairs = [(p, f) for p, f in zip(properties, fluxes) if f.exists()]
        if pairs:
            mapping.append((name, [p for p, _ in pairs], [f for _, f in pairs]))
    return mapping


def _optimization_block(cfg: dict, keys: list[str]) -> dict:
    return {getattr(constants, k): cfg[k] for k in keys if k in cfg}


def _stage_data(cfg: dict, config: dict, data_parser, heliostat_data_mapping) -> dict:
    """The reconstructor's data: a copy of ``data_parser`` (default: the PAINT parser)
    limited to the stage's ``sample_limit``, over ``heliostat_data_mapping`` (default:
    :func:`build_heliostat_data_mapping`)."""
    parser = copy.copy(data_parser) if data_parser is not None else PaintCalibrationDataParser()
    parser.sample_limit = cfg.get("sample_limit")
    if heliostat_data_mapping is None:
        heliostat_data_mapping = build_heliostat_data_mapping(config)
    return {constants.data_parser: parser, constants.heliostat_data_mapping: heliostat_data_mapping}


def _stage_scenario(scenario: Scenario, cfg: dict, device) -> Scenario:
    """The scenario on ``device``, its sun carrying the stage's ``number_of_rays``."""
    scenario.to(device)
    sun = scenario.light_sources[0]
    rays = int(cfg.get("number_of_rays", sun.number_of_rays))
    if rays != sun.number_of_rays:
        scenario.light_sources[0] = dataclasses.replace(sun, number_of_rays=rays)
    return scenario


def _save_histories(path: pathlib.Path, results) -> None:
    histories = {
        f"group_{r.group_index}": {key: [float(v) for v in values] for key, values in r.loss_history.items()}
        for r in results
    }
    with open(path, "w") as handle:
        json.dump(histories, handle, indent=2)


@track_runtime
def kinematics_evaluation(
    scenario: Scenario,
    config: dict,
    results_dir: pathlib.Path,
    distributed_setup=None,
    data_parser=None,
    heliostat_data_mapping: list | None = None,
    device: torch.device | str = "cuda",
    on_epoch=None,
):
    """The kinematics stage: ``KinematicsReconstructor`` with the block's method and
    optimizer; saves ``kinematics_reconstruction.npz`` (``final_loss``,
    ``group_<i>_rotation_deviations``) and ``kinematics_loss_history.json``. Returns
    the final losses and the group results."""
    cfg = config["kinematics_reconstruction_optimization_configuration"]
    reconstructor = KinematicsReconstructor(
        scenario=_stage_scenario(scenario, cfg, device),
        data=_stage_data(cfg, config, data_parser, heliostat_data_mapping),
        optimization_configuration={
            constants.optimization: _optimization_block(
                cfg, ["initial_learning_rate_rotation_deviation", *OPTIMIZATION_KEYS]
            ),
            constants.scheduler: _optimization_block(cfg, SCHEDULER_KEYS),
        },
        reconstruction_method=cfg.get("method", constants.kinematics_reconstruction_alignment),
        distributed_setup=distributed_setup,
    )
    final_loss, results = reconstructor.reconstruct_kinematics(on_epoch=on_epoch)
    np.savez(
        pathlib.Path(results_dir) / "kinematics_reconstruction.npz",
        final_loss=np.asarray(final_loss),
        **{
            f"group_{i}_rotation_deviations": g.rotation_deviations.cpu().numpy()
            for i, g in enumerate(scenario.heliostat_groups)
        },
    )
    with open(pathlib.Path(results_dir) / "kinematics_loss_history.json", "w") as handle:
        json.dump({f"group_{r.group_index}": [float(v) for v in r.loss_history] for r in results}, handle, indent=2)
    return final_loss, results


@track_runtime
def surface_evaluation(
    scenario: Scenario,
    config: dict,
    results_dir: pathlib.Path,
    distributed_setup=None,
    data_parser=None,
    heliostat_data_mapping: list | None = None,
    device: torch.device | str = "cuda",
    on_epoch=None,
    **options,
):
    """The surface stage: ``SurfaceReconstructor.reconstruct_surfaces("kl_divergence")``
    with the block's optimizer and constraints (``options``, such as ``ray_chunk``, go to
    the reconstructor); saves ``surface_reconstruction.npz`` (``final_loss``,
    ``group_<i>_control_points``) and ``surface_loss_history.json``."""
    cfg = config["surface_reconstruction_optimization_configuration"]
    reconstructor = SurfaceReconstructor(
        scenario=_stage_scenario(scenario, cfg, device),
        data=_stage_data(cfg, config, data_parser, heliostat_data_mapping),
        optimization_configuration={
            constants.optimization: _optimization_block(cfg, ["initial_learning_rate", *OPTIMIZATION_KEYS]),
            constants.scheduler: _optimization_block(cfg, SCHEDULER_KEYS),
            constants.constraints: _optimization_block(
                cfg, ["rho_flux_integral", "energy_tolerance", "weight_smoothness", "weight_ideal_surface"]
            ),
        },
        distributed_setup=distributed_setup,
        **options,
    )
    final_loss, results = reconstructor.reconstruct_surfaces("kl_divergence", on_epoch=on_epoch)
    np.savez(
        pathlib.Path(results_dir) / "surface_reconstruction.npz",
        final_loss=np.asarray(final_loss),
        **{
            f"group_{i}_control_points": g.nurbs_control_points.detach().cpu().numpy()
            for i, g in enumerate(scenario.heliostat_groups)
        },
    )
    _save_histories(pathlib.Path(results_dir) / "surface_loss_history.json", results)
    return final_loss, results


def aim_point_ground_truth(cfg: dict, resolution: tuple[int, int] = AIM_POINT_BITMAP) -> np.ndarray:
    """``outer(vertical, horizontal)`` trapezoids of the block's widths, passed to
    ``trapezoid_distribution`` as the JAX pipeline passes them (``trapezoid_plateau``
    as the slope width, ``trapezoid_slope`` as the plateau width)."""
    horizontal, vertical = (
        trapezoid_distribution(size, cfg["trapezoid_plateau"], cfg["trapezoid_slope"], device="cpu").numpy()
        for size in resolution
    )
    return np.outer(vertical, horizontal)


@track_runtime
def aim_point_evaluation(
    scenario: Scenario,
    config: dict,
    results_dir: pathlib.Path,
    distributed_setup=None,
    device: torch.device | str = "cuda",
    on_epoch=None,
    **options,
):
    """The aim-point stage: ``AimPointOptimizer.optimize("kl_divergence")`` towards the
    trapezoid, the sun in the south, target 0 (``options``, such as
    ``heliostat_chunk``, go to the optimizer); saves ``aim_point_optimization.npz``
    (``final_loss``, ``intercepts``, ``on_targets``, ``blockings``,
    ``group_<i>_motor_positions``) and ``aim_point_loss_history.json``."""
    cfg = config["aim_point_optimization_configuration"]
    optimizer = AimPointOptimizer(
        scenario=_stage_scenario(scenario, cfg, device),
        optimization_configuration={
            constants.optimization: _optimization_block(cfg, ["initial_learning_rate", *OPTIMIZATION_KEYS]),
            constants.scheduler: _optimization_block(
                cfg, ["scheduler_type", "lr_min", "reduce_factor", "patience", "threshold", "cooldown"]
            ),
            constants.constraints: _optimization_block(
                cfg, ["rho_flux_integral", "rho_local_flux", "rho_intercept", "max_flux_density"]
            ),
        },
        incident_ray_direction=list(SOUTH),
        target_area_index=0,
        ground_truth=aim_point_ground_truth(cfg),
        dni=float(cfg.get("dni", 800.0)),
        bitmap_resolution=AIM_POINT_BITMAP,
        distributed_setup=distributed_setup,
        **options,
    )
    final_loss, history, intercepts, on_targets, blockings = optimizer.optimize("kl_divergence", on_epoch=on_epoch)
    np.savez(
        pathlib.Path(results_dir) / "aim_point_optimization.npz",
        final_loss=np.asarray(final_loss),
        intercepts=intercepts.cpu().numpy().astype(np.float64),
        on_targets=on_targets.cpu().numpy().astype(np.float64),
        blockings=blockings.cpu().numpy().astype(np.float64),
        **{
            f"group_{i}_motor_positions": g.motor_positions.detach().cpu().numpy()
            for i, g in enumerate(scenario.heliostat_groups)
        },
    )
    with open(pathlib.Path(results_dir) / "aim_point_loss_history.json", "w") as handle:
        json.dump({key: [float(v) for v in values] for key, values in history.items()}, handle, indent=2)
    return final_loss, history, intercepts, on_targets, blockings


def run_pipeline(
    scenario: Scenario,
    config: dict,
    results_dir: pathlib.Path | str,
    distributed_setup=None,
    which: str = "all",
    data_parser=None,
    heliostat_data_mapping: list | None = None,
    device: torch.device | str = "cuda",
    stage_options: dict[str, dict] | None = None,
    on_epoch=None,
) -> dict:
    """The stages ``which`` names (one of :data:`STAGES`, or ``"all"``) in order on
    ``scenario``; ``stage_options`` holds the surface and aim-point stages' extra options
    by name, ``on_epoch(epoch, loss)`` goes to each stage's loop. Returns each stage's
    outputs by name."""
    results_dir = pathlib.Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    stage_options = stage_options or {}
    data = dict(data_parser=data_parser, heliostat_data_mapping=heliostat_data_mapping, on_epoch=on_epoch)
    stages = {
        "kinematics": lambda: kinematics_evaluation(
            scenario, config, results_dir, distributed_setup, **data, device=device
        ),
        "surface": lambda: surface_evaluation(
            scenario, config, results_dir, distributed_setup, **data, device=device, **stage_options.get("surface", {})
        ),
        "aim_point": lambda: aim_point_evaluation(
            scenario, config, results_dir, distributed_setup, device=device, on_epoch=on_epoch,
            **stage_options.get("aim_point", {})
        ),
    }
    if which != "all" and which not in stages:
        raise ValueError(f"unknown stage {which!r}: one of {STAGES} or 'all'")
    return {name: stage() for name, stage in stages.items() if which in (name, "all")}


def main(argv: list[str] | None = None) -> dict:
    parser = config_arguments(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    parser.add_argument("which", nargs="?", default="all", choices=(*STAGES, "all"), help="the stage(s) to run")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    set_logger_config()
    config = load_config(args.config, args.data_dir)
    results_dir = pathlib.Path(config["results_dir"])
    results_dir.mkdir(parents=True, exist_ok=True)
    set_runtime_logger(results_dir / "runtime_log.txt")

    scenario_path = pathlib.Path(config["scenarios_dir"]) / SCENARIO_FILE
    if not scenario_path.exists():
        scenario_path = generate_scenario(config)
    points = int(config["surface_reconstruction_optimization_configuration"]["number_of_surface_points"])
    scenario = load_scenario_from_hdf5(
        scenario_path, number_of_surface_points_per_facet=(points, points), device=args.device
    )
    # A process group of one, or of the torchrun environment's ranks, which share the
    # heliostat groups round-robin and merge their results.
    with setup_distributed_environment(len(scenario.heliostat_groups), device=args.device) as distributed_setup:
        outputs = run_pipeline(scenario, config, results_dir, distributed_setup, args.which, device=args.device)
    print(f"results written to {results_dir}")
    return outputs


if __name__ == "__main__":
    main()

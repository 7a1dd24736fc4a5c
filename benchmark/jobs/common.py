"""What every job's program side shares: the port's scenario built from a field's arrays,
the calibration parser over the traffic's samples, and the ARTIST train/test split."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from artist_tpu_torch.field.heliostat_group import HeliostatGroupState
from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.io.calibration import CalibrationData, CalibrationDataParser
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.scenario.scenario import Scenario
from artist_tpu_torch.scene.sun import Sun
from artist_tpu_torch.util import constants

OPTIMIZATION_KEYS = ("tolerance", "max_epoch", "batch_size", "log_step", "early_stopping_delta",
                     "early_stopping_patience", "early_stopping_window")
SCHEDULER_KEYS = ("scheduler_type", "lr_min", "lr_max", "step_size_up", "reduce_factor", "patience", "threshold",
                  "cooldown", "gamma")
TEST_FRACTION = 0.25


def optimized(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every parameter of every group of ``optimizer``, in order: the tensors the check
    compares, one leaf a row."""
    return [weight for group in optimizer.param_groups for weight in group["params"]]


def adam_first_gradient(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """After Adam's first step, the gradient as it got it: each parameter's first moment
    over 1 - beta1."""
    return [optimizer.state[weight]["exp_avg"].detach().clone() / (1 - group["betas"][0])
            for group in optimizer.param_groups for weight in group["params"]]


@dataclass
class Entry:
    """One job of the port, set up: ``call(on_epoch)`` runs the public entry once from
    the set-up state; ``restore()`` puts back the scenario's groups that a finished
    call replaced; ``max_epoch`` is the loop's (a call that ends before it stopped early);
    ``parameters(optimizer)`` and ``first_gradient(optimizer)`` read what the check
    compares from the optimizer that the entry steps."""

    call: Callable[[Callable[[int, float], None]], Any]
    restore: Callable[[], None]
    max_epoch: int
    parameters: Callable[[torch.optim.Optimizer], list[torch.Tensor]] = optimized
    first_gradient: Callable[[torch.optim.Optimizer], list[torch.Tensor]] = adam_first_gradient


def block(section: dict, keys) -> dict:
    return {key: section[key] for key in keys if key in section}


def names(count: int) -> tuple[str, ...]:
    return tuple(f"H{i:04d}" for i in range(count))


def port_scenario(arrays: dict, device) -> Scenario:
    """The port's one-group scenario of the field ``arrays``, its surfaces evaluated
    by the port's NURBS at the field's surface points."""
    count = arrays["positions"].shape[0]

    def tensor(name):
        return torch.as_tensor(arrays[name], device=device)

    canting, translations, control_points = tensor("canting"), tensor("translations"), tensor("control_points")
    degree = arrays["degree"]
    points, normals = evaluate_nurbs_surfaces(
        control_points[:1], (degree, degree), create_nurbs_evaluation_grid(arrays["surface_points"], device=device),
        canting=canting[:1], facet_translations=translations[:1],
    )
    static = tensor("static").clone()
    static[:, 0] = constants.linear_actuator_int
    group = HeliostatGroupState(
        positions=tensor("positions"),
        surface_points=points.reshape(1, -1, 4).expand(count, -1, -1).contiguous(),
        surface_normals=normals.reshape(1, -1, 4).expand(count, -1, -1).contiguous(),
        canting=canting,
        facet_translations=translations,
        nurbs_control_points=control_points,
        initial_orientations=torch.tensor([0.0, -1.0, 0.0, 0.0], device=device).expand(count, 4).contiguous(),
        translation_deviations=torch.zeros((count, 9), device=device),
        rotation_deviations=torch.zeros((count, 4), device=device),
        actuator_non_optimizable=static,
        actuator_optimizable=tensor("optimizable"),
        motor_positions=torch.zeros((count, 2), device=device),
        names=names(count),
        kinematics_type=constants.rigid_body_key,
        actuator_type=constants.linear_actuator_key,
        nurbs_degrees=(degree, degree),
    )
    empty = torch.zeros((0, 4), device=device)
    none = torch.zeros((0,), device=device)
    tower = SolarTower(
        planar_centers=tensor("receiver_center")[None],
        planar_normals=tensor("receiver_normal")[None],
        planar_dimensions=tensor("receiver_size")[None],
        cylindrical_centers=empty, cylindrical_axes=empty, cylindrical_normals=empty,
        cylindrical_radii=none, cylindrical_heights=none, cylindrical_opening_angles=none,
        planar_names=("receiver",), cylindrical_names=(),
    )
    return Scenario(
        power_plant_position=np.array([arrays["site"][key] for key in ("latitude_deg", "longitude_deg", "altitude_m")]),
        solar_tower=tower,
        light_sources=[Sun(number_of_rays=arrays["rays"],
                           distribution_parameters={
                               constants.light_source_distribution_type: constants.light_source_distribution_is_normal,
                               constants.light_source_mean: 0.0,
                               constants.light_source_covariance: arrays["covariance"],
                           })],
        heliostat_groups=[group],
        heliostat_group_names=[f"{constants.rigid_body_key}_{constants.linear_actuator_key}"],
    )


def parser_data(data: dict, sample_limit: int) -> dict:
    """The reconstructors' ``data`` argument: the port's in-memory parser over the samples."""
    calibration = CalibrationData(
        flux_measured=data["flux"], focal_spots=data["spots"], incident_ray_directions=data["incident"],
        motor_positions=data["motors"], active_heliostats_mask=data["counts"], target_area_indices=data["targets"],
    )
    return {
        constants.data_parser: CalibrationDataParser(calibration, names(len(data["counts"])), sample_limit),
        constants.heliostat_data_mapping: [],
    }


def split_rows(counts: np.ndarray, sample_limit: int) -> dict[str, np.ndarray]:
    """The rows of each split in ARTIST's order: each heliostat's first ``sample_limit``
    samples, of which the last quarter (at least one) are its test samples."""
    rows = {"train": [], "test": []}
    start = 0
    for count in counts:
        used = min(int(count), sample_limit)
        test = max(1, int(used * TEST_FRACTION)) if used else 0
        rows["train"].extend(range(start, start + used - test))
        rows["test"].extend(range(start + used - test, start + used))
        start += int(count)
    return {name: np.asarray(index, np.int64) for name, index in rows.items()}


def reference_split(data: dict, rows: np.ndarray, per_heliostat: np.ndarray, device) -> dict:
    """A split's samples as the reference reads them."""
    return dict(
        heliostat=torch.as_tensor(per_heliostat[rows], device=device),
        incident=torch.as_tensor(data["incident"][rows], device=device),
        flux=torch.as_tensor(data["flux"][rows], device=device),
        motors=torch.as_tensor(data["motors"][rows], device=device),
        spots=torch.as_tensor(data["spots"][rows], device=device),
    )


def validates(epoch: int, max_epoch: int, log_step: int, stopped: bool) -> bool:
    """Whether ARTIST's reconstruction loops validate after ``epoch``."""
    return epoch % (log_step or max_epoch) == 0 or epoch == max_epoch - 1 or stopped

"""Learning-rate schedules and early stopping of the inverse problems.

Counterpart of ``artist_tpu/optim/training.py:18-127``, as plain Python: a
schedule is a function of the epoch, ``ReduceOnPlateau`` a host-side
controller stepped with each epoch's loss. The optimizers read the rate once
per epoch and set it on their ``torch.optim`` parameter group. The ragged
train/test split of calibration data (``training.py:131-237``) is host numpy.

The reconstructors turn a split's host arrays into tensors on the run's device
with :func:`to_device`, which counts the bytes in ``TRANSFERS``.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from artist_tpu_torch.util import constants
from artist_tpu_torch.util.logging_utils import span

Schedule = Callable[[int], float]

TRANSFERS = {"host_to_device_bytes": 0}


def reset_transfer_counts() -> None:
    for name in TRANSFERS:
        TRANSFERS[name] = 0


def to_device(array, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The host array ``array`` as a tensor on ``device`` (``torch.as_tensor``); its
    bytes on the host are counted in ``TRANSFERS``, with no read of the device."""
    array = np.asarray(array)
    TRANSFERS["host_to_device_bytes"] += array.nbytes
    return torch.as_tensor(array, dtype=dtype, device=device)


def exponential_schedule(initial_learning_rate: float, parameters: dict) -> Schedule:
    """``lr * gamma^epoch``."""
    gamma = float(parameters[constants.gamma])
    return lambda step: initial_learning_rate * gamma**step


def cyclic_schedule(parameters: dict) -> Schedule:
    """Triangular cyclic rate (torch ``CyclicLR`` semantics) between ``lr_min`` and ``lr_max``."""
    base_lr = float(parameters[constants.lr_min])
    max_lr = float(parameters[constants.lr_max])
    step_size_up = int(parameters[constants.step_size_up])

    def schedule(step: int) -> float:
        cycle = math.floor(1 + step / (2 * step_size_up))
        x = abs(step / step_size_up - 2 * cycle + 1)
        return base_lr + (max_lr - base_lr) * max(0.0, 1 - x)

    return schedule


class ReduceOnPlateau:
    """Reduce-on-plateau rate controller: call ``step(loss)`` per epoch, read ``learning_rate``."""

    def __init__(self, initial_learning_rate: float, parameters: dict) -> None:
        self.learning_rate = initial_learning_rate
        self.factor = float(parameters[constants.reduce_factor])
        self.patience = int(parameters[constants.patience])
        self.threshold = float(parameters[constants.threshold])
        self.cooldown = int(parameters[constants.cooldown])
        self.min_lr = float(parameters[constants.lr_min])
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def step(self, loss: float) -> float:
        if loss < self.best * (1 - self.threshold):
            self.best = loss
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.learning_rate = max(self.learning_rate * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
        return self.learning_rate


def make_scheduler(initial_learning_rate: float, scheduler_config: dict) -> Schedule | ReduceOnPlateau:
    """A schedule (exponential, cyclic) or a :class:`ReduceOnPlateau`, by ``scheduler_type``."""
    scheduler_type = scheduler_config[constants.scheduler_type]
    parameters = scheduler_config.get(constants.scheduler, scheduler_config)
    if scheduler_type == constants.exponential:
        return exponential_schedule(initial_learning_rate, parameters)
    if scheduler_type == constants.cyclic:
        return cyclic_schedule(parameters)
    if scheduler_type == constants.reduce_on_plateau:
        return ReduceOnPlateau(initial_learning_rate, parameters)
    raise ValueError(f"Unknown scheduler type: {scheduler_type}")


class EarlyStopping:
    """Windowed relative-improvement early stopping: ``step(loss)`` returns True to stop."""

    def __init__(
        self,
        window_size: int = 10,
        patience: int = 20,
        min_improvement: float = 1e-4,
        relative: bool = True,
        eps: float = 1e-8,
    ) -> None:
        self.window_size = window_size
        self.patience = patience
        self.min_improvement = min_improvement
        self.relative = relative
        self.eps = eps
        self.loss_history: deque = deque(maxlen=window_size)
        self.counter = 0

    def step(self, loss: float) -> bool:
        self.loss_history.append(loss)
        if len(self.loss_history) < self.window_size:
            return False
        improvement = self.loss_history[0] - self.loss_history[-1]
        if self.relative:
            improvement /= max(abs(self.loss_history[0]), self.eps)
        if improvement > self.min_improvement:
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience


@dataclass
class TrainTestSplit:
    """Per-heliostat ordered train/test split of calibration data (host numpy)."""

    flux_measured_train: np.ndarray
    focal_spots_measured_train: np.ndarray
    incident_ray_directions_train: np.ndarray
    motor_positions_train: np.ndarray
    target_area_indices_train: np.ndarray

    flux_measured_test: np.ndarray
    focal_spots_measured_test: np.ndarray
    incident_ray_directions_test: np.ndarray
    motor_positions_test: np.ndarray
    target_area_indices_test: np.ndarray

    active_heliostats_mask_train: np.ndarray
    active_heliostats_mask_test: np.ndarray

    train_indices: np.ndarray
    test_indices: np.ndarray

    number_of_train_samples: int
    number_of_test_samples: int
    number_of_samples_per_heliostat: int


def train_test_split(
    active_heliostats_mask: np.ndarray,
    flux_measured: np.ndarray,
    focal_spots_measured: np.ndarray,
    incident_ray_directions: np.ndarray,
    motor_positions: np.ndarray,
    target_area_indices: np.ndarray,
    test_fraction: float = 0.25,
) -> TrainTestSplit:
    """Split ordered per-heliostat sample blocks: train from each block's start,
    test from its end.

    The blocks are ragged: heliostat ``h`` with ``c_h > 0`` samples gives
    ``max(1, int(c_h * test_fraction))`` test samples from the end of its
    block and the rest to training; one with none gives none. The
    ``number_of_*_samples`` fields hold the per-heliostat count where the
    counts are uniform and the largest one otherwise; the masks hold the
    per-heliostat counts.
    """
    active_heliostats_mask = np.asarray(active_heliostats_mask)
    counts = active_heliostats_mask.astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    test_counts = np.where(counts > 0, np.maximum(1, (counts * test_fraction).astype(np.int64)), 0)
    train_counts = counts - test_counts

    train_indices = np.concatenate(
        [np.arange(start, start + n_train) for start, n_train in zip(starts, train_counts)]
        or [np.empty(0, np.int64)]
    )
    test_indices = np.concatenate(
        [
            np.arange(start + n_train, start + count)
            for start, n_train, count in zip(starts, train_counts, counts)
        ]
        or [np.empty(0, np.int64)]
    )
    active_counts = counts[counts > 0]

    def take(x, index):
        return np.asarray(x)[index]

    return TrainTestSplit(
        flux_measured_train=take(flux_measured, train_indices),
        focal_spots_measured_train=take(focal_spots_measured, train_indices),
        incident_ray_directions_train=take(incident_ray_directions, train_indices),
        motor_positions_train=take(motor_positions, train_indices),
        target_area_indices_train=take(target_area_indices, train_indices),
        flux_measured_test=take(flux_measured, test_indices),
        focal_spots_measured_test=take(focal_spots_measured, test_indices),
        incident_ray_directions_test=take(incident_ray_directions, test_indices),
        motor_positions_test=take(motor_positions, test_indices),
        target_area_indices_test=take(target_area_indices, test_indices),
        active_heliostats_mask_train=train_counts.astype(active_heliostats_mask.dtype),
        active_heliostats_mask_test=test_counts.astype(active_heliostats_mask.dtype),
        train_indices=train_indices,
        test_indices=test_indices,
        number_of_train_samples=int(train_counts.max()) if counts.size else 0,
        number_of_test_samples=int(test_counts.max()) if counts.size else 0,
        number_of_samples_per_heliostat=int(active_counts.max()) if active_counts.size else 0,
    )


def group_calibration_split(
    data: dict, scenario, group, bitmap_resolution: tuple[int, int], group_index: int = 0, distributed_setup=None
) -> tuple[np.ndarray, TrainTestSplit] | None:
    """The calibration data of heliostat group ``group_index``, from ``data``'s
    parser, and its train/test split: (the group-local indices of the heliostats
    with data, the split), or None where the group has no sample or another rank of
    a group-parallel ``distributed_setup`` reconstructs it."""
    from artist_tpu_torch.parallel.env import runs_group

    if not runs_group(distributed_setup, group_index):
        return None
    with span("artist.entry.parse"):
        calibration = data[constants.data_parser].parse_data_for_reconstruction(
            heliostat_data_mapping=data[constants.heliostat_data_mapping],
            heliostat_names=group.names,
            target_name_to_index=scenario.solar_tower.target_name_to_index,
            power_plant_position=scenario.power_plant_position,
            bitmap_resolution=bitmap_resolution,
        )
    if calibration.active_heliostats_mask.sum() == 0:
        return None
    with span("artist.entry.split"):
        split = train_test_split(
            active_heliostats_mask=calibration.active_heliostats_mask,
            flux_measured=calibration.flux_measured,
            focal_spots_measured=calibration.focal_spots,
            incident_ray_directions=calibration.incident_ray_directions,
            motor_positions=calibration.motor_positions,
            target_area_indices=calibration.target_area_indices,
        )
    return np.nonzero(calibration.active_heliostats_mask)[0], split

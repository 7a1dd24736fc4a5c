"""Learning-rate schedules and early stopping of the inverse problems.

Counterpart of ``artist_tpu/optim/training.py:18-127``, as plain Python: a
schedule is a function of the epoch, ``ReduceOnPlateau`` a host-side
controller stepped with each epoch's loss. The optimizers read the rate once
per epoch and set it on their ``torch.optim`` parameter group. The train/test
split comes with the surface reconstructor.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable

from artist_tpu_torch.util import constants

Schedule = Callable[[int], float]


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

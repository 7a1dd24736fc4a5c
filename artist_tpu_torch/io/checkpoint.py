"""Training checkpoints as local ``.npz`` files.

Counterpart of ``artist_tpu/io/checkpoint.py``, with one backend: that
module's process-local ``.npz`` one. There is no orbax here. A state is a
nested dict of numpy arrays; each save writes ``<step>.npz`` under a
temporary name and renames it into place, so a torn write is never taken
for a step. Steps are found by numeric sort, and a save prunes all but the
newest ``max_to_keep``.

The files are this package's own: the JAX package does not read them, and
this package does not read the JAX package's checkpoints.
:func:`scenario_optimizable_state` and :func:`apply_optimizable_state` carry a
scenario's optimizable tensors into such a state and back, under the JAX
package's keys.
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import Any

import numpy as np
import torch

log = logging.getLogger("artist_tpu_torch.io")

OPTIMIZABLE_KEYS = (
    "nurbs_control_points",
    "translation_deviations",
    "rotation_deviations",
    "actuator_optimizable",
    "motor_positions",
)


def scenario_optimizable_state(scenario) -> dict[str, Any]:
    """Every heliostat group's optimizable tensors, as host numpy arrays:
    ``{"group_<i>": {key: array}}`` for the keys of :data:`OPTIMIZABLE_KEYS`."""
    return {
        f"group_{index}": {key: getattr(group, key).detach().cpu().numpy() for key in OPTIMIZABLE_KEYS}
        for index, group in enumerate(scenario.heliostat_groups)
    }


def apply_optimizable_state(scenario, state: dict[str, Any]):
    """Write a :func:`scenario_optimizable_state` back into ``scenario``'s groups, on
    each group's device and in its dtype, and return the scenario. An empty array
    replaces only an empty tensor (a group without actuator parameters), as in the
    JAX package."""
    for index, group in enumerate(scenario.heliostat_groups):
        replacements = {
            key: torch.as_tensor(np.asarray(value), dtype=getattr(group, key).dtype, device=group.positions.device)
            for key, value in state[f"group_{index}"].items()
            if np.asarray(value).size or getattr(group, key).numel() == 0
        }
        scenario.heliostat_groups[index] = group.replace(**replacements)
    return scenario


_KEY_SEPARATOR = "||"


def _flatten_state(state: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for key, value in state.items():
        path = f"{prefix}{_KEY_SEPARATOR}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten_state(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten_state(flat: dict[str, Any]) -> dict[str, Any]:
    state: dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split(_KEY_SEPARATOR)
        node = state
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return state


class CheckpointManager:
    """Periodic save and restore of nested dicts of numpy arrays in ``directory``.

    Parameters
    ----------
    directory : path
        Checkpoint root, created if missing.
    max_to_keep : int
        Steps kept after each save; at least 1.
    """

    def __init__(self, directory: pathlib.Path | str, max_to_keep: int = 3) -> None:
        if max_to_keep <= 0:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _steps(self) -> list[int]:
        return sorted(int(path.stem) for path in self.directory.glob("*.npz") if path.stem.isdigit())

    def save(self, step: int, state: dict[str, Any]) -> None:
        """Save ``state`` as step ``step``, then prune to ``max_to_keep`` steps."""
        final = self.directory / f"{step}.npz"
        temporary = self.directory / f"tmp_{os.getpid()}_{step}.npz"
        with open(temporary, "wb") as handle:
            np.savez(handle, **_flatten_state(state))
        temporary.replace(final)
        for stale in self._steps()[: -self.max_to_keep]:
            (self.directory / f"{stale}.npz").unlink(missing_ok=True)
        log.info("Saved checkpoint at step %d to %s.", step, self.directory)

    @property
    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict[str, Any] | None:
        """The state of ``step`` (by default the latest), or None where there is none."""
        if step is None:
            step = self.latest_step
        if step is None:
            return None
        path = self.directory / f"{step}.npz"
        if not path.exists():
            return None
        with np.load(path) as archive:
            state = _unflatten_state({key: archive[key] for key in archive.files})
        log.info("Restored checkpoint step %d from %s.", step, self.directory)
        return state

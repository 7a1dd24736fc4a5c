"""Checkpoint and resume of the optimizers' epoch loops.

Counterpart of ``artist_tpu/optim/checkpointing.py``. Each loop saves its
whole resume state every ``every`` epochs through
:class:`~artist_tpu_torch.io.checkpoint.CheckpointManager`: the optimized
parameters, the ``torch.optim`` state, the Augmented-Lagrangian multipliers
and references, the scheduler and early-stopping state, the loss histories
and the epoch; on a restart it restores them and continues the same
trajectory.

Nested containers (a ``torch.optim`` ``state_dict``, tuples of per-group
tensors) are packed into flat string-keyed dicts of numpy arrays whose keys
record the structure, so that :func:`unpack_pytree` rebuilds them without a
template: ``torch.optim.Adam`` creates its moments only at its first step,
so a fresh optimizer's ``state_dict`` has none to fill.
"""

from __future__ import annotations

import pathlib
from typing import Any

import numpy as np
import torch

from artist_tpu_torch.io.checkpoint import CheckpointManager
from artist_tpu_torch.optim import training

# A packed key is the path of a leaf, one segment per container level, then
# "=" and the leaf's kind. A segment is "s:<key>" (dict, str key), "i:<key>"
# (dict, int key), "l:<index>" (list) or "t:<index>" (tuple). Empty
# containers are leaves of their own kind, so that they survive the round trip.
_SEGMENT_SEPARATOR = "/"
_EMPTY = {"Ed": dict, "El": list, "Et": tuple}


def _pack(tree: Any, path: str, out: dict[str, np.ndarray]) -> None:
    def child(segment: str) -> str:
        return f"{path}{_SEGMENT_SEPARATOR}{segment}" if path else segment

    if isinstance(tree, dict):
        if not tree:
            out[f"{path}=Ed"] = np.zeros(0)
        for key, value in tree.items():
            if isinstance(key, bool) or not isinstance(key, (str, int)):
                raise TypeError(f"cannot pack a dict key of type {type(key).__name__}")
            segment = f"i:{key}" if isinstance(key, int) else f"s:{key}"
            if _SEGMENT_SEPARATOR in segment or "=" in segment or "||" in segment:
                raise ValueError(f"cannot pack the dict key {key!r}")
            _pack(value, child(segment), out)
    elif isinstance(tree, (list, tuple)):
        kind = "l" if isinstance(tree, list) else "t"
        if not tree:
            out[f"{path}=E{kind}"] = np.zeros(0)
        for index, value in enumerate(tree):
            _pack(value, child(f"{kind}:{index}"), out)
    elif isinstance(tree, torch.Tensor):
        out[f"{path}=T"] = tree.detach().cpu().numpy()
    elif isinstance(tree, np.ndarray):
        out[f"{path}=A"] = tree
    elif tree is None:
        out[f"{path}=N"] = np.zeros(0)
    elif isinstance(tree, bool):
        out[f"{path}=b"] = np.asarray(tree)
    elif isinstance(tree, int):
        out[f"{path}=i"] = np.asarray(tree, np.int64)
    elif isinstance(tree, float):
        out[f"{path}=f"] = np.asarray(tree, np.float64)
    else:
        raise TypeError(f"cannot pack a leaf of type {type(tree).__name__}")


def pack_pytree(tree: Any) -> dict[str, np.ndarray]:
    """Flatten nested dicts, lists and tuples of tensors, arrays, numbers and
    None into a string-keyed dict of numpy arrays that records the structure."""
    out: dict[str, np.ndarray] = {}
    _pack(tree, "", out)
    return out


def _leaf(kind: str, value: np.ndarray, device) -> Any:
    if kind == "T":
        return torch.as_tensor(np.array(value), device=device)
    if kind == "A":
        return np.array(value)
    if kind == "N":
        return None
    if kind in _EMPTY:
        return _EMPTY[kind]()
    return {"b": bool, "i": int, "f": float}[kind](value.item())


def _build(node: Any) -> Any:
    if not isinstance(node, dict):
        return node[0]
    segments = list(node)
    prefix = segments[0][:2]
    if prefix in ("l:", "t:"):
        ordered = [_build(node[s]) for s in sorted(segments, key=lambda s: int(s[2:]))]
        return ordered if prefix == "l:" else tuple(ordered)
    return {int(s[2:]) if s.startswith("i:") else s[2:]: _build(node[s]) for s in segments}


def unpack_pytree(packed: dict[str, Any], device: torch.device | str | None = None) -> Any:
    """Rebuild what :func:`pack_pytree` packed; tensors on ``device`` (the CPU by default)."""
    root: dict[str, Any] = {}
    for key, value in packed.items():
        path, kind = key.rsplit("=", 1)
        leaf = (_leaf(kind, np.asarray(value), device),)
        if not path:
            return leaf[0]
        node = root
        segments = path.split(_SEGMENT_SEPARATOR)
        for segment in segments[:-1]:
            node = node.setdefault(segment, {})
        node[segments[-1]] = leaf
    return _build(root)


def scheduler_state(scheduler: Any) -> dict[str, np.ndarray]:
    """A scheduler's mutable state; a marker for the schedules, which are functions of the epoch."""
    if isinstance(scheduler, training.ReduceOnPlateau):
        return {
            "learning_rate": np.float64(scheduler.learning_rate),
            "best": np.float64(scheduler.best),
            "num_bad_epochs": np.int64(scheduler.num_bad_epochs),
            "cooldown_counter": np.int64(scheduler.cooldown_counter),
        }
    return {"stateless": np.int64(1)}


def restore_scheduler(scheduler: Any, state: dict[str, Any]) -> None:
    if isinstance(scheduler, training.ReduceOnPlateau) and "learning_rate" in state:
        scheduler.learning_rate = float(state["learning_rate"])
        scheduler.best = float(state["best"])
        scheduler.num_bad_epochs = int(state["num_bad_epochs"])
        scheduler.cooldown_counter = int(state["cooldown_counter"])


def early_stopping_state(stopper: training.EarlyStopping) -> dict[str, np.ndarray]:
    return {
        "loss_history": np.asarray(list(stopper.loss_history), np.float64),
        "counter": np.int64(stopper.counter),
    }


def restore_early_stopping(stopper: training.EarlyStopping, state: dict[str, Any]) -> None:
    stopper.loss_history.clear()
    stopper.loss_history.extend(np.asarray(state["loss_history"]).tolist())
    stopper.counter = int(state["counter"])


def pack_history(history: dict[str, list[float]] | list[float]) -> dict | np.ndarray:
    if isinstance(history, dict):
        return {key: np.asarray(value, np.float64) for key, value in history.items()}
    return np.asarray(history, np.float64)


def restore_history(history: dict[str, list[float]] | list[float], state: Any) -> None:
    """Refill a history (a list, or a dict of lists) in place from its packed form."""
    if isinstance(history, dict):
        for key in history:
            history[key][:] = np.asarray(state[key]).tolist()
    else:
        history[:] = np.asarray(state).tolist()


def world_options(distributed_setup) -> dict[str, Any]:
    """:class:`LoopCheckpointer`'s ``world_size`` and ``writer`` for a run: each rank of
    a group-parallel run writes its own groups; of the ranks of a nested run, which
    hold the same state, rank 0 writes."""
    from artist_tpu_torch.parallel import collectives
    from artist_tpu_torch.parallel.env import is_group_parallel

    return {
        "world_size": collectives.world_size(),
        "writer": is_group_parallel(distributed_setup) or collectives.rank() == 0,
    }


def refuse_other_worlds(directory: pathlib.Path | str, labels: set[str], prefix: str) -> None:
    """Raise ``ValueError`` where ``directory`` holds a saved step under a label that
    starts with ``prefix`` and is not one of ``labels``: a loop whose labels depend
    on the world size (``aim_point`` alone, ``aim_point_rank{r}`` on each rank of a
    group-parallel run) was written by another world, and would otherwise restart
    from epoch 0 without a word."""
    root = pathlib.Path(directory)
    if not root.is_dir():
        return
    for path in sorted(root.glob(f"{prefix}*")):
        if path.is_dir() and path.name not in labels and CheckpointManager(path).latest_step is not None:
            raise ValueError(
                f"{path} holds a checkpoint of another world size (this run's: {sorted(labels)}): "
                "resume it with the world size that wrote it"
            )


class LoopCheckpointer:
    """Periodic checkpoints of one optimization loop.

    Parameters
    ----------
    directory : path
        The optimizers' ``checkpoint_dir``.
    label : str
        This loop's subdirectory (``"surface_group_0"``, ``"aim_point"``), so
        that several loops share one root.
    every : int
        Save every ``every`` epochs (epoch 0 never; 0 saves nothing).
    max_to_keep : int
        Steps kept; at least 1.
    per_process : bool
        Accepted and ignored, as :class:`~artist_tpu_torch.io.checkpoint.CheckpointManager`
        does: the port's checkpoints are always local to the process.
    world_size : int
        Processes of the run. Each save records it, and a checkpoint written by
        another world size raises on restore: a loop's state (its groups, its
        share of the parameters) belongs to the world that wrote it, and a fresh
        start from epoch 0 would silently drop it.
    writer : bool
        Whether this process writes. The ranks of a nested run hold the same state,
        and only one of them saves it.
    """

    def __init__(
        self, directory: pathlib.Path | str, label: str, every: int = 25, max_to_keep: int = 3,
        per_process: bool = False, world_size: int = 1, writer: bool = True,
    ) -> None:
        self.every = int(every)
        self.label = label
        self.world_size = int(world_size)
        self.writer = writer
        self._manager = CheckpointManager(
            pathlib.Path(directory) / label, max_to_keep=max_to_keep, per_process=per_process
        )

    def restore_latest(self) -> dict[str, Any] | None:
        """The latest saved state, or None for a fresh start. Raises ``ValueError``
        for a state that another world size wrote."""
        restored = self._manager.restore()
        if restored is not None:
            written_by = int(restored.get("world_size", 1))
            if written_by != self.world_size:
                raise ValueError(
                    f"the checkpoint {self.label} was written by a run of {written_by} process(es); "
                    f"this run has {self.world_size}: resume it with the world size that wrote it"
                )
        return restored

    def should_save(self, epoch: int) -> bool:
        return self.writer and self.every > 0 and epoch > 0 and epoch % self.every == 0

    def save(self, epoch: int, state: dict[str, Any]) -> None:
        self._manager.save(epoch, dict(state, epoch=np.int64(epoch), world_size=np.int64(self.world_size)))

    def save_loop(self, epoch: int, optimizer: torch.optim.Optimizer, scheduler, stopper: training.EarlyStopping,
                  history, last_loss: float, **state) -> None:
        """Save a loop's state at ``epoch``: the optimizer's, the scheduler's, the early
        stopping's, the history and the last loss, and the loop's own ``state``."""
        self.save(epoch, {
            "opt_state": pack_pytree(optimizer.state_dict()),
            "last_loss": np.float64(last_loss),
            "scheduler": scheduler_state(scheduler),
            "early_stopping": early_stopping_state(stopper),
            "history": pack_history(history),
            **state,
        })

    def restore_loop(self, optimizer: torch.optim.Optimizer, scheduler, stopper: training.EarlyStopping,
                     history) -> tuple[int, float, dict[str, Any]] | None:
        """Restore the latest :meth:`save_loop` into the optimizer, scheduler, early
        stopping and history in place. Returns (the epoch to continue from, the last
        loss, the whole saved state), or None for a fresh start."""
        restored = self.restore_latest()
        if restored is None:
            return None
        optimizer.load_state_dict(unpack_pytree(restored["opt_state"]))
        restore_scheduler(scheduler, restored["scheduler"])
        restore_early_stopping(stopper, restored["early_stopping"])
        restore_history(history, restored["history"])
        return int(restored["epoch"]) + 1, float(restored["last_loss"]), restored

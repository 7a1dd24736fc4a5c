"""Logging configuration, runtime tracking and spans.

Counterpart of ``artist_tpu/util/logging_utils.py``: plain stdlib logging for
the ``artist_tpu_torch`` logger hierarchy, a runtime logger that appends
start, finish and duration records to a file, a decorator that writes them
around a function (synchronising the card before each reading of the clock,
so that a duration covers the device work the function queued) and a
``torch.profiler`` trace around a phase.

:func:`span` is the port's one span mechanism: a ``record_function`` range while
a profiler records, on the profiler's clock beside the device's kernels, copies
and the runtime's syncs, and one shared object that does nothing otherwise. The
reconstruction loops open spans named ``artist.<layer>.<stage>`` at their layer
boundaries (``artist.entry.*``, ``artist.optim.*``, ``artist.aten.*``,
``artist.kernels.*``), so that a trace written by :func:`profile_trace` shows
each stage of a call, and the host's time can be put down to its layer.

The JAX package's ``enable_compilation_cache`` keeps XLA's compiled programs
across processes; PyTorch runs eagerly and compiles nothing of the port's, so
it has no counterpart here. What plays its part is the kernels' build cache
(:mod:`artist_tpu_torch.kernels.build`): each CUDA library is built once per
source, headers and flags, and found again by its hash.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from pathlib import Path
from typing import Any, Callable, TypeVar

import torch

F = TypeVar("F", bound=Callable[..., Any])

runtime_log = logging.getLogger("artist_tpu_torch.runtime")
"""Dedicated logger for runtime-tracking records."""


def set_logger_config(
    level: int = logging.INFO,
    log_file: str | Path | None = None,
    log_to_stderr: bool = True,
    process_index: int | None = None,
) -> None:
    """Configure the ``artist_tpu_torch`` logger hierarchy.

    Parameters
    ----------
    level : int
        Log level (default ``logging.INFO``).
    log_file : str | Path | None
        Optional file to log to as well.
    log_to_stderr : bool
        Whether to attach a stream handler.
    process_index : int | None
        Process index shown in the format; None reads this process's rank in the
        initialised process group (0 without one).
    """
    if process_index is None:
        from artist_tpu_torch.parallel import collectives

        process_index = collectives.rank()
    base_logger = logging.getLogger("artist_tpu_torch")
    base_logger.setLevel(level)
    base_logger.handlers.clear()
    formatter = logging.Formatter(
        fmt=f"[%(asctime)s][p{process_index}][%(name)s][%(levelname)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if log_to_stderr:
        handler = logging.StreamHandler()
        handler.setFormatter(formatter)
        base_logger.addHandler(handler)
    if log_file is not None:
        file_handler = logging.FileHandler(str(log_file))
        file_handler.setFormatter(formatter)
        base_logger.addHandler(file_handler)
    base_logger.propagate = False


def set_runtime_logger(path: str | Path = "runtime_log.txt", level: int = logging.INFO) -> None:
    """Attach a file handler to the runtime logger."""
    runtime_log.setLevel(level)
    handler = logging.FileHandler(str(path))
    handler.setFormatter(logging.Formatter(fmt="[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
    runtime_log.addHandler(handler)
    runtime_log.propagate = False


_IDLE = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str, args: str | Callable[[], str] | None = None):
    """A profiler range named ``name`` around a stage, where a profiler records::

        with span("artist.optim.epoch", lambda: str(epoch)):
            ...

    While no profiler records it is one shared object that does nothing on entry or
    exit: the call costs one probe of the profiler's state, no allocation and no
    formatting. While one records it is ``torch.profiler.record_function(name, args)``;
    ``args`` (a string, or a callable returning one, called only then) is the
    range's argument in the trace. A span reads no device value and does not
    synchronise, so it changes neither the launches nor their order.
    """
    if not _profiler_enabled():
        return _IDLE
    return torch.profiler.record_function(name, args() if callable(args) else args)


def _synchronize() -> None:
    """Wait for the card's queued work, where there is a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: str | Path):
    """A ``torch.profiler`` trace (host and, where there is a card, device) around a phase,
    written as a Chrome trace under ``log_dir``::

        with profile_trace("profile"):
            optimizer.optimize()
    """
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    runtime_log.info("profile trace started: %s", log_dir)
    with torch.profiler.profile(activities=activities) as profiler:
        yield profiler
        _synchronize()
    profiler.export_chrome_trace(str(log_dir / "trace.json"))
    runtime_log.info("profile trace written: %s", log_dir)


def track_runtime(function: F) -> F:
    """Decorator logging the start, finish and wall-clock duration of a function.

    The card is synchronised before each reading of the clock, so the duration
    covers the device work the function queued. That costs two waits for the card
    a call, so it wraps whole phases (the examples' stages), never a hot path: use
    :func:`span` there. The call also shows as a :func:`span` in a profiler trace.
    """

    @functools.wraps(function)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        name = f"{function.__module__}.{function.__qualname__}"
        runtime_log.info("started: %s", name)
        _synchronize()
        start = time.perf_counter()
        with span(name):
            result = function(*args, **kwargs)
        _synchronize()
        runtime_log.info("finished: %s duration_s=%.6f", name, time.perf_counter() - start)
        return result

    return wrapper  # type: ignore[return-value]

"""``blocking.host_ms_per_step``: the host's own time in the blocking layer inside the epochs of the
traced call, over its epochs, in ms: the self time (:mod:`benchmark.spans`) of the ``artist.blocking.*``
spans (the mask, its primitives and its candidate test) and of the sigma operators'
``artist.kernels.sigma_*`` spans (their checks and launches, or the plain versions). None where the
program opens no epoch span or no such span inside one."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("benchmark_spans", pathlib.Path(__file__).parents[1] / "spans.py")
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)

PREFIXES = ("artist.blocking.", "artist.kernels.sigma_")


def read(run) -> float | None:
    trace = run.trace
    if trace is None or not trace.epochs:
        return None
    partition = _spans.epoch_partition(trace)
    if partition is None:
        return None
    owned = [seconds for name, seconds in partition[0].items() if name.startswith(PREFIXES)]
    return 1e3 * sum(owned) / trace.epochs if owned else None

"""``step_p99_ms``: the 99th percentile of the window's epoch times (host clock), for cells whose
window holds some thousands of epochs, so that ten or more lie beyond it. Epochs are timed as for
``step_p95_ms``."""

import importlib.util
import pathlib

PERCENTILE = 99.0

_spec = importlib.util.spec_from_file_location("step_p95_ms", pathlib.Path(__file__).with_name("step_p95_ms.py"))
_p95 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p95)


def read(run) -> float | None:
    if not run.epoch_seconds:
        return None
    return 1e3 * _p95.percentile(run.epoch_seconds, PERCENTILE)

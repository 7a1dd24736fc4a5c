"""``busy_step_p95_ms``: ``step_p95_ms`` under a bound of its own, in the cells whose card is busy (idle
under a tenth of the traced call), where runs part by little and a bound as wide as the host-bound
cells' would hide a loss."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("step_p95_ms", pathlib.Path(__file__).with_name("step_p95_ms.py"))
_p95 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p95)

read = _p95.read

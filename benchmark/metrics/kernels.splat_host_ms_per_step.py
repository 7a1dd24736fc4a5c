"""``kernels.splat_host_ms_per_step``: the host's own time in the splat's autograd functions
(``artist.kernels.splat_forward`` and ``artist.kernels.splat_backward`` spans: checks, the
kernels' launches or the plain versions) inside the epochs of the traced call, over its epochs,
in ms, by the self time of :mod:`benchmark.spans`. None where the program opens no epoch span."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("benchmark_spans", pathlib.Path(__file__).parents[1] / "spans.py")
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)

PREFIX = "artist.kernels.splat_"


def read(run) -> float | None:
    return _spans.host_ms_per_step(run.trace, PREFIX)

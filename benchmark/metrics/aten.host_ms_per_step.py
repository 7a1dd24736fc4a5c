"""``aten.host_ms_per_step``: the host's own time in the ``artist.aten.*`` spans inside the epochs of the
traced call, over its epochs, in ms: each span's self time (its interval less its children's and
less the host's waits for the device in it; :mod:`benchmark.spans`). ``optim.host_ms_per_step``,
``aten.host_ms_per_step`` and ``kernels.splat_host_ms_per_step``, with the waits inside the epochs,
sum to the epoch spans' time. None where the program opens no epoch span."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("benchmark_spans", pathlib.Path(__file__).parents[1] / "spans.py")
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)

PREFIX = "artist.aten."


def read(run) -> float | None:
    return _spans.host_ms_per_step(run.trace, PREFIX)

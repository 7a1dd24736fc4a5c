"""``entry.preamble_ms``: the host's time in each call's preamble, in ms: the ``artist.entry.preamble``
spans of the traced call summed (one a heliostat group: the calibration's parse and split, the
batches copied to the card, the steps and the optimizer built, the reference render), from
the profiler's trace (:mod:`benchmark.spans`). None where the program opens no such span."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("benchmark_spans", pathlib.Path(__file__).parents[1] / "spans.py")
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run) -> float | None:
    if run.trace is None:
        return None
    preambles = [end - start for name, start, end in _spans.spans(run.trace) if name == _spans.PREAMBLE]
    return 1e3 * sum(preambles) if preambles else None

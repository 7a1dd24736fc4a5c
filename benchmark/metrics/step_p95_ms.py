"""``step_p95_ms``: the 95th percentile of the window's epoch times (host clock).

An epoch's time is the gap between two consecutive ends of epochs reported to the
entry's ``on_epoch`` hook; the window's first epoch is timed from its start. The
percentile interpolates linearly between the two nearest ranks."""

PERCENTILE = 95.0


def percentile(values: list[float], q: float) -> float:
    ordered = sorted(values)
    rank = (len(ordered) - 1) * q / 100.0
    low = int(rank)
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (rank - low)


def read(run) -> float | None:
    if not run.epoch_seconds:
        return None
    return 1e3 * percentile(run.epoch_seconds, PERCENTILE)

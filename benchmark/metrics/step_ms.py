"""``step_ms``: the window's wall time over the optimizer epochs completed in it (host clock)."""


def read(run) -> float | None:
    if not run.epoch_seconds:
        return None
    return 1e3 * run.window_s / len(run.epoch_seconds)

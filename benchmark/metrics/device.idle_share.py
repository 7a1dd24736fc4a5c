"""``device.idle_share``: the share of the traced stretch in which no kernel, copy or
fill ran on the device (the union of their intervals, from the profiler's trace), in %."""


def read(run) -> float | None:
    trace = run.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)

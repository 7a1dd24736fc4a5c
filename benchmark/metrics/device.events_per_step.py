"""``device.events_per_step``: kernels, copies and fills on the device in the traced
stretch, over its epochs."""


def read(run) -> float | None:
    trace = run.trace
    if trace is None or not trace.device or not trace.epochs:
        return None
    return len(trace.device) / trace.epochs

"""``optim.host_syncs_per_step``: the host's waits for the device in the traced stretch,
over its epochs: the runtime's stream, device and event synchronizations, and its
synchronous copies to the host (``cudaMemcpy`` whose copy runs device to host; an
asynchronous copy to the host is followed by a stream synchronization, counted once)."""

SYNCHRONIZATIONS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
SYNCHRONOUS_COPIES = ("cudaMemcpy", "cudaMemcpy2D")


def read(run) -> float | None:
    trace = run.trace
    if trace is None or not trace.epochs:
        return None
    syncs = 0
    for name, start, end, correlation in trace.runtime:
        if not trace.start <= start <= trace.end:
            continue
        if name in SYNCHRONIZATIONS:
            syncs += 1
        elif name in SYNCHRONOUS_COPIES and "dtoh" in trace.copies.get(correlation, "").lower():
            syncs += 1
    return syncs / trace.epochs

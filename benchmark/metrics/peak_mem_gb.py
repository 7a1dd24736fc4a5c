"""``peak_mem_gb``: the program's peak of allocated device memory (``torch.cuda.max_memory_allocated``,
reset once the traffic is made), in 1e9 bytes."""


def read(run) -> float | None:
    return None if run.peak_bytes is None else run.peak_bytes / 1e9

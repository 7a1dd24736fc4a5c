"""``entry.h2d_mb_per_call``: the bytes that one call of the entry copies from the host to the card
for its batches, in 1e6 bytes: the program's counter ``artist_tpu_torch.optim.training.TRANSFERS``
(each host array's size, counted on the host as the batches hand it to the device).

The harness reads the program's launch counters over the traced call alone, and this counter
over the process: a traced run calls the entry :data:`CALLS` times (the set-up's first call, its
preamble whole, ended after the check's epochs; then the traced call: ``benchmark/run.py``), and
every call of a run makes the same batches. None where the program has no such counter."""

import importlib

CALLS = 2
COUNTERS = "artist_tpu_torch.optim.training"


def read(run) -> float | None:
    if run.trace is None:
        return None
    transfers = getattr(importlib.import_module(COUNTERS), "TRANSFERS", None)
    if not transfers or not transfers.get("host_to_device_bytes"):
        return None
    return transfers["host_to_device_bytes"] / CALLS / 1e6

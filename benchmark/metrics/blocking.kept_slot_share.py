"""``blocking.kept_slot_share``: the share of the candidate slots that the corridor test kept, in %,
over the port's newest compacted-route forwards in the traced call
(``artist_tpu_torch.raytracing.blocking.STATISTICS``, read after the run). The sigma pair's
work grows with it. None where the port has no such counter or ran no compacted forward."""

import importlib

COUNTER = "artist_tpu_torch.raytracing.blocking"


def read(run) -> float | None:
    statistics = getattr(importlib.import_module(COUNTER), "blocking_statistics", None)
    if run.trace is None or statistics is None:
        return None
    counted = statistics()
    if not counted["candidate_slots"]:
        return None
    return 100.0 * counted["kept_slots"] / counted["candidate_slots"]

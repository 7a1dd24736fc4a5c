"""The program's spans in a traced stretch, and the host's time inside the epochs by layer.

The port opens spans named ``artist.<layer>.<stage>`` at its layer boundaries
(``artist_tpu_torch.util.logging_utils.span``: ``record_function`` ranges while the
profiler records). On the card's PyTorch the profiler's events report no activity type,
so :func:`benchmark.trace.from_profiler` files these ranges among the host's operators
(``Trace.host``), and they are read from there by their prefix; a PyTorch whose events
report the type drops them, and the readers then find none and read nothing. A program
without spans gives none either.

**Self time.** A span's parent is the shortest span that contains it in time, on any
thread (the loop's thread waits inside ``backward()`` while the autograd engine's thread
runs the splat's backward). A span's self time is its interval less the union of its
children's intervals, less the host's waits for the device within it: the runtime calls
that ``optim.host_syncs_per_step`` counts (stream, device and event synchronizations, and
synchronous copies to the host). So each instant of an epoch belongs to exactly one span,
the shortest that holds it, or to a wait, and the self times of the spans inside the
epochs plus the waits there sum to the epochs' time.

Run as a script it profiles one whole call of a cell's entry, as a ``--trace 1`` run does,
and prints where the call's time went by span (:func:`breakdown`)::

    python3 benchmark/spans.py --workload <cell> --seed <n>
"""

from __future__ import annotations

import argparse
import heapq
import importlib.util
import json
import pathlib
import sys

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

PREFIX = "artist."
EPOCH = "artist.optim.epoch"
PREAMBLE = "artist.entry.preamble"

_spec = importlib.util.spec_from_file_location(
    "optim_host_syncs_per_step", pathlib.Path(__file__).with_name("metrics") / "optim.host_syncs_per_step.py"
)
_syncs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_syncs)


def spans(trace) -> list[tuple[str, float, float]]:
    """The program's spans in the trace, (name, start, end), by start."""
    return sorted(((name, start, end) for name, start, end in trace.host if name.startswith(PREFIX)),
                  key=lambda span: (span[1], -span[2]))


def sync_waits(trace) -> list[tuple[float, float, str]]:
    """The host's waits for the device: (start, end, runtime call), by start."""
    return sorted(
        (start, end, name) for name, start, end, correlation in trace.runtime
        if name in _syncs.SYNCHRONIZATIONS
        or (name in _syncs.SYNCHRONOUS_COPIES and "dtoh" in trace.copies.get(correlation, "").lower())
    )


def innermost(intervals: list[tuple[str, float, float]], points: list[float]) -> list[str | None]:
    """For each of the sorted ``points``, the name of the shortest interval that holds it
    (None where none does)."""
    ordered = sorted(intervals, key=lambda interval: interval[1])
    active: list[tuple[float, float, str]] = []  # heap keyed by duration
    owners, cursor = [], 0
    for point in points:
        while cursor < len(ordered) and ordered[cursor][1] <= point:
            name, start, end = ordered[cursor]
            heapq.heappush(active, (end - start, end, name))
            cursor += 1
        while active and active[0][1] <= point:
            heapq.heappop(active)
        owners.append(active[0][2] if active else None)
    return owners


def inside(spans_: list[tuple[str, float, float]], outers: list[tuple[str, float, float]]) -> list:
    """The spans that lie within one of ``outers`` (the outers included)."""
    bounds = sorted((start, end) for _, start, end in outers)
    kept = []
    for span in spans_:
        _, start, end = span
        if any(outer_start <= start and end <= outer_end for outer_start, outer_end in bounds):
            kept.append(span)
    return kept


def epoch_partition(trace) -> tuple[dict[str, float], float, float] | None:
    """The epochs' time split by owner: (self seconds by span name, seconds of waits, the
    epoch spans' seconds), over the spans inside the ``artist.optim.epoch`` spans; None
    where the trace holds no epoch span."""
    found = spans(trace)
    epochs = [span for span in found if span[0] == EPOCH]
    if not epochs:
        return None
    held = inside(found, epochs)
    waits = [(start, end) for start, end, _ in sync_waits(trace)]
    edges = sorted({t for _, start, end in held for t in (start, end)}
                   | {t for start, end in waits for t in (start, end)})
    middles = [(a + b) / 2 for a, b in zip(edges, edges[1:])]
    owners = innermost(held, middles)
    waiting = innermost([("wait", start, end) for start, end in waits], middles)
    self_s: dict[str, float] = {}
    waits_s = 0.0
    for (a, b), owner, wait in zip(zip(edges, edges[1:]), owners, waiting):
        if owner is None:
            continue
        if wait is not None:
            waits_s += b - a
        else:
            self_s[owner] = self_s.get(owner, 0.0) + (b - a)
    return self_s, waits_s, sum(end - start for _, start, end in epochs)


def host_ms_per_step(trace, prefix: str) -> float | None:
    """The self time of the spans inside the epochs whose names start with ``prefix``,
    over the stretch's epochs, in ms."""
    if trace is None or not trace.epochs:
        return None
    partition = epoch_partition(trace)
    if partition is None:
        return None
    self_s = partition[0]
    return 1e3 * sum(seconds for name, seconds in self_s.items() if name.startswith(prefix)) / trace.epochs


def syncs_by_span(trace) -> dict[str, int]:
    """The host's waits for the device, counted by the shortest span and the shortest host
    operator that hold each one's start: "span | operator" ("None" where none does)."""
    waits = sync_waits(trace)
    starts = [start for start, _, _ in waits]
    operators = [(name, start, end) for name, start, end in trace.host if not name.startswith(PREFIX)]
    counts: dict[str, int] = {}
    for owner, operator in zip(innermost(spans(trace), starts), innermost(operators, starts)):
        key = f"{owner} | {operator}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def breakdown(trace) -> dict:
    """Where a traced stretch's time went by span: the stretch a step, the spans inside the
    epochs a step, the preamble's spans (ms, summed by name), the share of the stretch that
    the preambles and the epochs cover, the waits a step by span and operator, the epochs'
    partition (ms a step), and the share of the device's idle time under no span or operator."""
    from benchmark import trace as tracing

    found = spans(trace)
    epochs = [span for span in found if span[0] == EPOCH]
    preambles = [span for span in found if span[0] == PREAMBLE]
    steps = max(trace.epochs, 1)
    stages: dict[str, float] = {}
    for name, start, end in inside(found, preambles):
        stages[name] = stages.get(name, 0.0) + 1e3 * (end - start)
    out = {
        "stretch_ms_per_step": 1e3 * trace.window_s / steps,
        "spans_in_epochs_per_step": (len(inside(found, epochs)) - len(epochs)) / steps,
        "preamble_ms": stages,
        "preamble_and_epochs_share": sum(end - start for _, start, end in epochs + preambles) / trace.window_s,
        "syncs_per_step": {key: count / steps for key, count in sorted(syncs_by_span(trace).items())},
    }
    partition = epoch_partition(trace)
    if partition is not None:
        self_s, waits_s, epochs_s = partition
        out["epoch_self_ms_per_step"] = {name: 1e3 * seconds / steps for name, seconds in sorted(self_s.items())}
        out["epoch_waits_ms_per_step"] = 1e3 * waits_s / steps
        out["epoch_ms_per_step"] = 1e3 * epochs_s / steps
    idle = trace.window_s - trace.busy_s()
    labels = dict(tracing.idle_gaps(trace, entries=len(trace.host) + len(trace.runtime) + 1))
    out["idle_unnamed_share"] = labels.get("no operator on the host", 0.0) / idle if idle > 0 else 0.0
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Where one traced call of a cell's entry spent its time, by span.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    import torch

    from benchmark import run
    from benchmark.field import field_arrays

    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    from artist_tpu_torch.kernels.build import build_all

    build_all()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, workload, config = run.cell(run.ROOT, args.workload)
    job = run.job_module(run.ROOT, config["job"])
    arrays = field_arrays(config["field"])
    data = job.make_traffic(arrays, workload["traffic_parameters"], args.seed, device)
    entry = job.build(config, workload, arrays, data, args.seed, device)
    run.first_steps(entry, int(workload["check"]["steps"]))
    stretch, _ = run.traced_call(entry, job, device)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": run.card_line(), **breakdown(stretch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

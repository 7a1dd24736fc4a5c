"""The traced stretch: device intervals, host runtime calls and operators from ``torch.profiler``.

The per-layer metric readers (``benchmark/metrics/``) read a :class:`Trace`; the
breakdown (the device operations that took longest, and the idle gaps by what
the host was doing) is taken from it too. Times are seconds on the profiler's
clock; the interval arithmetic is plain Python so that the tests can feed it
records of their own.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

import torch

BREAKDOWN_ENTRIES = 10


@dataclass
class Trace:
    """One traced stretch of whole epochs.

    ``device``: (name, start, end, kind) with kind "kernel", "memcpy" or "memset";
    ``runtime``: the host's CUDA runtime calls, (name, start, end, correlation);
    ``host``: the host's operators, (name, start, end);
    ``copies``: correlation -> the device copy's name, for the runtime's memcpy calls;
    ``epochs``: epochs completed in the stretch, ``start``/``end`` its bounds;
    ``counters``: the program's launch counters over the stretch, by module; ``work``:
    what the job needed in the stretch of each kernel family, as its ``kernel_work`` lists it."""

    device: list[tuple[str, float, float, str]]
    runtime: list[tuple[str, float, float, int]]
    host: list[tuple[str, float, float]]
    start: float
    end: float
    epochs: int
    copies: dict[int, str] = field(default_factory=dict)
    counters: dict[str, dict[str, int]] = field(default_factory=dict)
    work: dict[str, list] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The device's busy intervals inside the stretch."""
        clipped = [(max(start, self.start), min(end, self.end)) for _, start, end, _ in self.device]
        return union([(start, end) for start, end in clipped if end > start])

    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals())


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The disjoint intervals covering ``intervals``, in order."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(start, end) for start, end in merged]


def device_kind(name: str) -> str:
    lowered = name.lower()
    if lowered.startswith("memcpy"):
        return "memcpy"
    if lowered.startswith("memset"):
        return "memset"
    return "kernel"


STRETCH = "benchmark.stretch"  # the host annotation around the traced stretch
# CUDA runtime and driver calls, where the profiler does not say which events those are.
RUNTIME_NAME = re.compile(r"^cu(da)?[A-Z]")


def activity_of(event) -> str | None:
    """The event's kineto activity ("kernel", "cuda_runtime", "cpu_op", ...), where this
    PyTorch reports it."""
    return str(event.activity_type()) if hasattr(event, "activity_type") else None


def from_profiler(profiler: torch.profiler.profile, epochs: int) -> Trace:
    """The records of a finished profiler in seconds from the stretch's start; the
    stretch is the host annotation :data:`STRETCH` (``torch.profiler.record_function``)."""
    events = profiler.profiler.kineto_results.events()
    stretch = [e for e in events if e.name() == STRETCH and e.device_type() != torch.autograd.DeviceType.CUDA]
    if not stretch:
        raise RuntimeError(f"the trace holds no {STRETCH!r} annotation")
    base = stretch[0].start_ns()
    bounds = (0.0, stretch[0].duration_ns() * 1e-9)
    # A range the host annotates (record_function) may also appear on the device's
    # timeline under the same name: no kernel, copy or fill is named like a host event.
    host_names = {e.name() for e in events if e.device_type() != torch.autograd.DeviceType.CUDA}
    device, runtime, host, copies = [], [], [], {}
    for event in events:
        name = event.name()
        begin = (event.start_ns() - base) * 1e-9
        finish = begin + event.duration_ns() * 1e-9
        activity = activity_of(event)
        if name == STRETCH or (activity is not None and "annotation" in activity):
            continue
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            if activity is None and name in host_names:
                continue
            kind = device_kind(name)
            device.append((name, begin, finish, kind))
            if kind == "memcpy":
                copies[event.correlation_id()] = name
        elif ("runtime" in activity or "driver" in activity) if activity is not None else RUNTIME_NAME.match(name):
            runtime.append((name, begin, finish, event.correlation_id()))
        elif activity is None or activity == "cpu_op":
            host.append((name, begin, finish))
    return Trace(device=device, runtime=runtime, host=host, start=bounds[0], end=bounds[1], epochs=epochs,
                 copies=copies)


def top_device_ops(trace: Trace, entries: int = BREAKDOWN_ENTRIES) -> list[list]:
    """The device operations that took most time in the stretch, summed by name."""
    totals: dict[str, float] = {}
    for name, start, end, _ in trace.device:
        totals[name] = totals.get(name, 0.0) + (end - start)
    ranked = sorted(totals.items(), key=lambda item: item[1], reverse=True)[:entries]
    return [[name[:160], seconds] for name, seconds in ranked]


def idle_gaps(trace: Trace, entries: int = BREAKDOWN_ENTRIES) -> list[list]:
    """The device's idle time in the stretch, summed by what the host was doing at the
    middle of each gap: the latest-started operator or runtime call still running then."""
    busy = [(start, end) for start, end in trace.busy_intervals() if end > trace.start and start < trace.end]
    edges = [trace.start] + [t for interval in busy for t in interval] + [trace.end]
    gaps = [(max(a, trace.start), min(b, trace.end)) for a, b in zip(edges[::2], edges[1::2])]
    gaps = sorted((a, b) for a, b in gaps if b > a)
    activities = sorted([(start, end, name) for name, start, end in trace.host]
                        + [(start, end, name) for name, start, end, _ in trace.runtime])
    running: list[tuple[float, float, str]] = []  # heap keyed by the latest start
    totals: dict[str, float] = {}
    cursor = 0
    for start, end in gaps:
        middle = (start + end) / 2
        while cursor < len(activities) and activities[cursor][0] <= middle:
            begin, finish, name = activities[cursor]
            heapq.heappush(running, (-begin, finish, name))
            cursor += 1
        while running and running[0][1] < middle:
            heapq.heappop(running)
        label = running[0][2] if running else "no operator on the host"
        totals[label] = totals.get(label, 0.0) + (end - start)
    ranked = sorted(totals.items(), key=lambda item: item[1], reverse=True)[:entries]
    return [[name[:160], seconds] for name, seconds in ranked]

"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration file (the
deployment: field, published optimizer settings, the job) and its workload file
``benchmark/workloads/<cell>.json`` (the traffic's parameters, the check's steps
and limits). The run:

1. makes the traffic from ``--seed`` by the job's generator and sets up the port's
   job (:mod:`benchmark.jobs`: the job module that the configuration names);
2. runs the job's public entry for the check's first epochs, recording its losses,
   Adam's first moment after one step and the parameters before and after
   (``torch.optim``'s global step hooks), which warms every shape the window uses;
3. with ``--trace 0``, measures for ``--seconds``: call after call of the entry from
   the set-up state, ended at the first epoch end past the time; with ``--trace 1``,
   profiles one whole call instead;
4. reads the peak memory, frees the program, runs the reference's first steps on the
   same samples and compares (:mod:`benchmark.check`);
5. prints the compared numbers with their limits on standard error, then the result.

Each metric of the cell comes from its reader, ``benchmark/metrics/<metric>.py``.
Needs a CUDA card; exits non-zero without one, or if JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
if __name__ == "__main__":
    # Run as a script: import from the checkout's root, never from this folder (its
    # trace.py would shadow the standard library's).
    sys.path[0] = str(ROOT)

import torch  # noqa: E402
from torch.optim.optimizer import register_optimizer_step_post_hook, register_optimizer_step_pre_hook  # noqa: E402

from benchmark import check  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.field import field_arrays  # noqa: E402
from benchmark.reference.steps import Readings  # noqa: E402

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "artist_tpu")


class Stop(Exception):
    """Raised from the entry's ``on_epoch`` hook to end a call."""


@dataclass
class Run:
    """What a run measured, as the metric readers read it."""

    epoch_seconds: list[float] = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float | None = None
    peak_bytes: int | None = None
    trace: tracing.Trace | None = None


def manifest(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(root: pathlib.Path, name: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, the manifest's cell, its workload file, its configuration file)."""
    bench = manifest(root)
    entries = {entry["name"]: entry for entry in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    workload = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / config_entry["file"]).read_text())
    return bench, entry, workload, config


def reader(root: pathlib.Path, metric: str):
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_module(root: pathlib.Path, name: str):
    """The job module ``benchmark/jobs/<name>.py`` of the checkout at ``root``, loaded from its file."""
    path = root / "benchmark" / "jobs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.jobs.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, name: str, traced: bool) -> list[dict]:
    metrics = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in metrics if name in m.get("workloads", [name])]


def first_steps(entry, steps: int) -> Readings:
    """One call of the entry ended after ``steps`` epochs, with what its optimizer did:
    the entry's ``parameters`` before the first step and after the last, and its
    ``first_gradient`` after the first."""
    readings = Readings()
    taken = 0

    def before(optimizer, args, kwargs):
        if taken == 0:
            readings.start = [weight.detach().clone() for weight in entry.parameters(optimizer)]

    def after(optimizer, args, kwargs):
        nonlocal taken
        taken += 1
        if taken == 1:
            readings.first_gradient = entry.first_gradient(optimizer)
        if taken == steps:
            readings.end = [weight.detach().clone() for weight in entry.parameters(optimizer)]

    def on_epoch(epoch, loss):
        readings.losses.append(float(loss))
        if len(readings.losses) == steps:
            raise Stop

    handles = [register_optimizer_step_pre_hook(before), register_optimizer_step_post_hook(after)]
    try:
        entry.restore()
        entry.call(on_epoch)
        raise RuntimeError(f"the entry returned before {steps} epochs")
    except Stop:
        pass
    finally:
        for handle in handles:
            handle.remove()
    return readings


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(entry, seconds: float, device: torch.device, run: Run) -> int:
    """Calls of the entry from the set-up state until the first epoch end past
    ``seconds``; each epoch timed from the end of the one before. Returns the calls made."""
    synchronize(device)
    start = last = time.perf_counter()

    def on_epoch(epoch, loss):
        nonlocal last
        now = time.perf_counter()
        run.epoch_seconds.append(now - last)
        last = now
        if now - start >= seconds:
            raise Stop

    calls = 0
    while True:
        calls += 1
        epochs_before = len(run.epoch_seconds)
        entry.restore()
        try:
            entry.call(on_epoch)
        except Stop:
            break
        if len(run.epoch_seconds) == epochs_before:
            raise RuntimeError("a call of the entry ran no epoch")
    run.window_s = last - start
    return calls


def traced_call(entry, job, device: torch.device) -> tuple[tracing.Trace, list[dict]]:
    """One whole call of the entry under the profiler, and the call's shape. The
    ``LAUNCHES`` counters of the job's ``LAUNCH_COUNTERS`` modules are read over it."""
    counters = {module: importlib.import_module(module).LAUNCHES for module in job.LAUNCH_COUNTERS}
    epochs: list[int] = []
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = {module: dict(launches) for module, launches in counters.items()}
    entry.restore()
    synchronize(device)
    with torch.profiler.profile(activities=activities) as profiler:
        with torch.profiler.record_function(tracing.STRETCH):
            entry.call(lambda epoch, loss: epochs.append(epoch))
            synchronize(device)
    stretch = tracing.from_profiler(profiler, len(epochs))
    stretch.counters = {module: {name: count - before[module][name] for name, count in launches.items()}
                        for module, launches in counters.items()}
    return stretch, [{"epochs": len(epochs), "stopped": len(epochs) - 1 < entry.max_epoch}]


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def halves_step_ms(epoch_seconds: list[float]) -> list[float]:
    """The step time of the window's first and second half (split at the epoch that ends
    past its middle): how far one run drifts, beside how far runs part."""
    ends = list(itertools.accumulate(epoch_seconds))
    middle = next(index for index, end in enumerate(ends) if end >= ends[-1] / 2) + 1
    first, second = epoch_seconds[:middle], epoch_seconds[middle:]
    return [1e3 * sum(part) / len(part) for part in (first, second) if part]


def stamp(phase: str) -> None:
    """The seconds since the process started, at the end of a set-up phase, on standard error."""
    print(f"setup {phase}: {time.perf_counter() - PROCESS_START:.3f} s", file=sys.stderr)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float, traced: bool, device: torch.device) -> dict:
    """Run cell ``name`` once; returns the result line's object, the compared numbers last."""
    bench, entry_spec, workload, config = cell(root, name)
    job = job_module(root, config["job"])
    check_spec = workload["check"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        from artist_tpu_torch.kernels.build import build_all

        build_all()
    stamp("kernels")
    arrays = field_arrays(config["field"])
    data = job.make_traffic(arrays, workload["traffic_parameters"], seed, device)
    synchronize(device)
    stamp("traffic")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    entry = job.build(config, workload, arrays, data, seed, device)
    program = first_steps(entry, int(check_spec["steps"]))
    synchronize(device)
    stamp("first steps")

    run = Run(setup_s=time.perf_counter() - PROCESS_START)
    calls = None
    if traced:
        run.trace, calls = traced_call(entry, job, device)
        attempted = run.trace.epochs
        window = {"calls": 1, "epochs": attempted}
    else:
        window = {"calls": timed_window(entry, seconds, device, run), "epochs": len(run.epoch_seconds),
                  "median_epoch_ms": 1e3 * statistics.median(run.epoch_seconds),
                  "halves_step_ms": halves_step_ms(run.epoch_seconds)}
        attempted = len(run.epoch_seconds)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    inputs = job.reference_inputs(config, workload, arrays, data, seed, device)
    reference = job.reference_steps(inputs, int(check_spec["steps"]), int(check_spec["block"]), device)
    numbers = check.compare(program, reference)
    limits = {key: float(value) for key, value in check_spec["limits"].items()}
    # A number the program left no reading for is infinite: written as a string, as JSON has no infinity.
    checked = {key: {"value": numbers[key] if math.isfinite(numbers[key]) else str(numbers[key]), "limit": limit}
               for key, limit in limits.items()}
    if traced:
        run.trace.work = job.kernel_work(inputs, int(check_spec["block"]), calls, config["optimization"], device)

    metrics = {}
    for metric in cell_metrics(bench, name, traced):
        value = reader(root, metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {
        "correct": check.verdict(numbers, limits),
        "attempted": attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": int(entry_spec["chips"]), "memory_peak_bytes": run.peak_bytes},
    }
    if traced:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": tracing.top_device_ops(run.trace),
                               "idle_gaps": tracing.idle_gaps(run.trace)}
    result["card"] = card_line() if device.type == "cuda" else "cpu"
    result["window"] = window
    result["checked"] = checked
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    chips = int({w["name"]: w for w in manifest(ROOT)["workloads"]}.get(args.workload, {}).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"window: {result['window']}")
    for key, item in result["checked"].items():
        print(f"{key} {item['value']!r} limit {item['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where one of the port's paths spends its time on the card: a torch.profiler breakdown.

    python3 profile_torch_step.py [--path surface_step] [--steps 3] [--out profile_out]

``--path`` picks what a step is, each built exactly as ``chip_smoke.py``
drives it:

- ``surface_step``: the flagship surface-reconstruction step (100 heliostats,
  50 x 50 points per facet x 4 facets, 32 rays per point, 256 x 256 bitmaps,
  ray chunks of 4, Adam on the NURBS control points);
- ``blocking_step``: the same step with field-wide blocking on (K = 16);
- ``blocking_step_flat``: the same on the flat blocking route (every
  primitive, with the AABB cull);
- ``surface_step_block_window``: the surface step with the dynamic-window
  splat (``splat_block_window=96``, its ray blocks cut point-major over
  10 x 10 point tiles from the rays in place);
- ``aim_point``: one epoch of the aim-point optimizer at ``bench.py``'s size
  (100 heliostats, 8 rays per point, 8 M rays, blocking with K = 16): the
  loss with its three penalty terms, its backward and the Adam update;
- ``aim_point_flat``: the same epoch on the flat blocking route;
- ``surface_reconstruction``: one train epoch of ``SurfaceReconstructor`` at
  ``chip_smoke.py`` phase 12's configuration (``bench.py``'s production
  campaign: 36 train samples x 180 rays x 10,000 points = 64.8 M rays, ray
  chunks of 12, the cyclic rate, the energy constraint and the ideal-surface
  regularizer), as its loop runs it without validation: the objective, its
  backward, the edge lock, the Adam update, the multiplier update and the
  loss fetched to the host;
- ``plant_aim_point``: one epoch of the plant-scale example's optimizer at its
  defaults (``chip_smoke.py`` phase 14a: 4,000 heliostats in checkpointed
  chunks of 500, 2 rays per point, 80 M rays, K = 16);
- ``xl_step``: one step of ``bench.py``'s ``xl_field`` entry (phase 14b: the
  flagship step on 4,000 heliostats x 2 rays per point, ray chunks of 1,
  heliostat chunks of 500, blocking with K = 16);
- ``kinematics_alignment`` and ``kinematics_raytracing``: one train epoch of
  ``KinematicsReconstructor`` with that method at ``chip_smoke.py`` phase
  13's production calibration (100 heliostats x 15 train samples, 50 x 50
  points per facet x 4 facets, 19 rays per point, 256 x 256 maps; the
  flux-driven epoch traces its 285 M rays in one call) on the samples built
  from known rotation deviations, as its loop runs it without validation:
  the objective, its backward, the gradient scrub, the Adam update and the
  loss fetched to the host for the reduce-on-plateau rate.

It runs one warm-up step, times ``--steps`` steps with the profiler off (host
clock around synchronised steps), then profiles ``--steps`` more and prints:

- the step time with the profiler off and on;
- per step: device busy time (the union of all kernel and copy intervals),
  the device's idle share of the step, and the number of device events;
- the device time of the port's own kernels (splat and blocking) and of
  everything else;
- the top kernels by device time;
- the calls and the device time of a few operators (``OPS``: the reorder
  ``index_select``, the ``index_add_`` and zero-fill of its backward, copies).

It writes the full ``key_averages`` table and a Chrome trace under ``--out``.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

import chip_smoke
from artist_tpu_torch.examples import plant_scale_aim_points
from artist_tpu_torch.kernels.build import build_all
from artist_tpu_torch.optim import training
from artist_tpu_torch.util import constants

PORT_KERNELS = (
    "band_accumulate_kernel", "splat_backward_kernel", "sigma_forward_kernel", "sigma_backward_kernel",
    "blocking_cull_kernel", "sigma_flat_forward_kernel", "sigma_flat_backward_kernel", "sigma_flat_reduce_kernel",
)
# The operators whose calls and device time a step the summary lists: those of a reorder
# of ray streams (an index_select, and the index_add_ and zero-fill of its backward) and copies.
OPS = (
    "aten::index_select", "aten::index_select_backward", "aten::index_add_", "aten::index_add", "aten::zeros",
    "aten::new_zeros", "aten::zero_", "aten::fill_", "aten::copy_", "aten::contiguous", "aten::clone",
)
PATHS = (
    "surface_step", "blocking_step", "blocking_step_flat", "surface_step_block_window", "aim_point", "aim_point_flat",
    "surface_reconstruction", "kinematics_alignment", "kinematics_raytracing", "plant_aim_point", "xl_step",
)


def surface_step(device: torch.device, blocking: bool, candidates: int | None, **splat_options):
    return surface_step_of(chip_smoke.flagship_inputs(device, blocking=blocking, candidates=candidates, **splat_options))


def surface_step_of(inputs: chip_smoke.StepInputs):
    """A step of the flagship step on ``inputs``: loss, backward, Adam on the control points."""
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([control_points], lr=chip_smoke.LEARNING_RATE)

    def step() -> None:
        optimizer.zero_grad(set_to_none=True)
        chip_smoke.surface_loss(control_points, inputs).backward()
        optimizer.step()

    return step


def aim_point_epoch(device: torch.device, candidates: int | None, aim_point=None):
    """An epoch of ``aim_point`` (an AimPointOptimizer; by default bench.py's aim-point
    optimizer with ``candidates``) as its loop runs it: loss, backward, Adam."""
    if aim_point is None:
        scenario = chip_smoke.aim_point_scenario(
            device, chip_smoke.AIM_HELIOSTATS, chip_smoke.AIM_SURFACE_POINTS, chip_smoke.AIM_RAYS
        )
        aim_point = chip_smoke.aim_point_optimizer(
            scenario, chip_smoke.aim_point_ground_truth(chip_smoke.BITMAP, device), 0, candidates, chip_smoke.BITMAP,
        )
    params, forward, loss_fn = aim_point.objective("kl_divergence")
    with torch.no_grad():
        flux, intercepts, _, _ = forward(params)
    references = (flux.sum(), intercepts)
    lambdas = (torch.zeros((), device=device),) * 3
    for param in params:
        param.requires_grad_(True)
    optimizer = torch.optim.Adam(params, lr=chip_smoke.AIM_LEARNING_RATE, eps=1e-8)

    def step() -> None:
        optimizer.zero_grad(set_to_none=True)
        loss_fn(params, references, lambdas)[0].backward()
        optimizer.step()

    return step


def reconstruction_epoch(device: torch.device):
    """A train epoch of phase 12's reconstructor, as its loop runs it without
    validation: the rate of its schedule, the train step, the loss fetched to the host."""
    reconstructor = chip_smoke.surface_reconstructor(device, chip_smoke.RECON_EPOCHS[1])
    group = reconstructor.scenario.heliostat_groups[0]
    unique, split = training.group_calibration_split(
        reconstructor.data, reconstructor.scenario, group, reconstructor.bitmap_resolution
    )
    (train_batch,) = reconstructor._batches(group, split, unique, test=False)
    train_step, _, reference_integrals, _ = reconstructor._build_step_functions(group, "kl_divergence")
    control_points = group.nurbs_control_points.detach().clone().requires_grad_(True)
    original_control_points = control_points.detach()[torch.as_tensor(unique, device=device)]
    optimizer = torch.optim.Adam([control_points], eps=1e-8)
    schedule = training.make_scheduler(
        reconstructor.optimizer_dict[constants.initial_learning_rate], reconstructor.scheduler_dict
    )
    flux_ref = reference_integrals(control_points, train_batch)
    state = {"epoch": 0, "lambda": torch.zeros(unique.shape[0], device=device)}

    def step() -> None:
        state["lambda"], loss, _ = train_step(
            control_points, optimizer, state["lambda"], flux_ref, original_control_points, train_batch,
            float(schedule(state["epoch"])),
        )
        state["epoch"] += 1
        loss.item()

    return step


def kinematics_epoch(device: torch.device, method: str):
    """A train epoch of phase 13's kinematics reconstructor with ``method``, as its loop
    runs it without validation: the rate, the train step, the loss to the host."""
    alignment = method == constants.kinematics_reconstruction_alignment
    size = chip_smoke.KINEMATICS if alignment else chip_smoke.KINEMATICS_FLUX
    known = chip_smoke.known_rotation_deviations(size["heliostats"])
    data = chip_smoke.kinematics_calibration(chip_smoke.kinematics_scenario(device, size), known, size["samples"],
                                             size["bitmap"])
    reconstructor = chip_smoke.kinematics_reconstructor(
        device, size, data, method, chip_smoke.kinematics_configuration(chip_smoke.KINEMATICS_EPOCHS[1])
    )
    group = reconstructor.scenario.heliostat_groups[0]
    unique, split = training.group_calibration_split(reconstructor.data, reconstructor.scenario, group, size["bitmap"])
    (train_batch,) = reconstructor._batches(group, split, unique, test=False)
    train_step, _, _ = reconstructor._build_step_functions(reconstructor._default_loss(None))
    rotation_deviations = group.rotation_deviations.detach().clone().requires_grad_(True)
    optimizer = torch.optim.Adam([rotation_deviations], eps=1e-8)
    scheduler = training.make_scheduler(
        reconstructor.optimizer_dict[constants.initial_learning_rate_rotation_deviation], reconstructor.scheduler_dict
    )

    def step() -> None:
        loss, _ = train_step(rotation_deviations, optimizer, train_batch, scheduler.learning_rate)
        scheduler.step(loss.item())

    return step


def _timed_steps(steps: int, step) -> list[float]:
    seconds = []
    for _ in range(steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    return seconds


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=PATHS, default="surface_step")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", type=pathlib.Path, default=pathlib.Path("profile_out"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build_all()

    candidates = None if args.path.endswith("_flat") else chip_smoke.AIM_CANDIDATES
    if args.path == "surface_reconstruction":
        step = reconstruction_epoch(device)
    elif args.path.startswith("kinematics_"):
        step = kinematics_epoch(device, args.path.removeprefix("kinematics_"))
    elif args.path.startswith("aim_point"):
        step = aim_point_epoch(device, candidates)
    elif args.path == "plant_aim_point":
        step = aim_point_epoch(device, candidates, plant_scale_aim_points.make_optimizer(device=device))
    elif args.path == "xl_step":
        step = surface_step_of(chip_smoke.xl_inputs(device, True, candidates, chip_smoke.XL["heliostat_chunk"]))
    elif args.path == "surface_step_block_window":
        step = surface_step(device, False, candidates, **chip_smoke.BLOCK_WINDOW)
    else:
        step = surface_step(device, args.path.startswith("blocking_step"), candidates)
    _timed_steps(1, step)  # warm-up
    plain_seconds = _timed_steps(args.steps, step)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as profiler:
        profiled_seconds = _timed_steps(args.steps, step)

    device_events = [
        event for event in profiler.events()
        if event.device_type == torch.autograd.DeviceType.CUDA
    ]
    intervals = [(e.time_range.start, e.time_range.end) for e in device_events]
    busy_ms = _union_us(intervals) / 1e3 / args.steps
    by_name: dict[str, list[float]] = {}
    for event in device_events:
        by_name.setdefault(event.name, []).append(event.time_range.elapsed_us() / 1e3)
    rows = sorted(
        ((sum(times) / args.steps, len(times) / args.steps, name) for name, times in by_name.items()),
        reverse=True,
    )
    port_ms = {kernel: sum(ms for ms, _, name in rows if kernel in name) for kernel in PORT_KERNELS}
    ops = {
        event.key: {
            "calls_per_step": event.count / args.steps,
            "self_device_ms_per_step": event.self_device_time_total / 1e3 / args.steps,
            "device_ms_per_step": event.device_time_total / 1e3 / args.steps,
        }
        for event in profiler.key_averages()
        if event.key in OPS
    }
    step_ms = 1e3 * sum(profiled_seconds) / args.steps
    summary = {
        "card": card,
        "path": args.path,
        "steps": args.steps,
        "step_ms_profiler_off": [1e3 * s for s in plain_seconds],
        "step_ms_profiler_on": [1e3 * s for s in profiled_seconds],
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "device_events_per_step": len(device_events) / args.steps,
        "port_kernels_ms_per_step": port_ms,
        "other_device_ms_per_step": busy_ms - sum(port_ms.values()),
        "ops": ops,
        "top": [
            {"name": name[:120], "ms_per_step": ms, "calls_per_step": calls}
            for ms, calls, name in rows[:15]
        ],
    }
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "key_averages.txt").write_text(
        profiler.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    )
    profiler.export_chrome_trace(str(args.out / "trace.json"))
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the flagship step's time goes, by ablation.

Counterpart of ``tools/ablate_step.py``: the flagship step
(:mod:`artist_tpu_torch.tools.flagship_step`, at ``bench.py``'s defaults: 100
heliostats, 50 x 50 points a facet x 4 facets, 32 rays a point, ray chunks of 4)
timed three ways, each after a synchronised warm-up: the full forward and
backward, the forward alone, and the forward and backward with the trace and the
splat ablated (NURBS and alignment only)::

    python -m artist_tpu_torch.tools.ablate_step [--block-window 96] [--steps 15] [--device cuda]

On the card the times come from CUDA events around ``--steps`` calls; on the CPU
from the host clock (the CPU's time, not the card's). ``--block-window 96`` times
the dynamic-window splat (``bench.py``'s ``BENCH_SPLAT_BLOCK_WINDOW``).

Do not add an "ablate NURBS" variant that drops the NURBS evaluation while still
differentiating with respect to the control points: the loss then no longer
depends on them, nothing of the backward is left to run, and the "forward and
backward" time measures the forward alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from artist_tpu_torch.tools import flagship_step
from artist_tpu_torch.tools.flagship_step import StepInputs, aligned_surfaces, field_inputs, surface_loss

POINT_TILE = 10  # the block window's point tiles, as bench.py cuts them


def ablated_loss(control_points: torch.Tensor, inputs: StepInputs) -> torch.Tensor:
    """The step without trace and splat: NURBS and alignment, reduced to a scalar that
    reads every aligned point and normal and both distortion tensors."""
    points, normals = aligned_surfaces(control_points, inputs)
    return points.mean() + normals.mean() + inputs.distortions_u.mean() + inputs.distortions_e.mean()


def elapsed_ms(fn, steps: int, device: torch.device) -> float:
    """Milliseconds a call of ``fn``: one warm-up call, then ``steps`` calls, timed by CUDA
    events on the card (synchronised before and after) and by the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - start) * 1e3 / steps
    torch.cuda.synchronize(device)
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return begin.elapsed_time(end) / steps


def ablate(
    device: torch.device | str = "cuda",
    heliostats: int = flagship_step.HELIOSTATS,
    surface_points: tuple[int, int] = flagship_step.SURFACE_POINTS,
    rays: int = flagship_step.RAYS,
    ray_chunk: int | None = flagship_step.RAY_CHUNK,
    block_window: int | None = None,
    steps: int = 15,
) -> dict:
    """The three times, in ms a call: ``full`` (forward and backward), ``forward`` and
    ``geometry`` (forward and backward with trace and splat ablated), and the rays a
    call traces."""
    device = torch.device(device)
    inputs = field_inputs(device, heliostats, surface_points, rays, ray_chunk=ray_chunk)
    if block_window:
        window = dict(
            splat_block_window=block_window, splat_point_layout=(*surface_points, 4), splat_point_tile=POINT_TILE
        )
        inputs = dataclasses.replace(inputs, config=dataclasses.replace(inputs.config, **window))
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)

    def backward(loss_fn):
        def call() -> None:
            control_points.grad = None
            loss_fn(control_points, inputs).backward()

        return call

    def forward() -> None:
        with torch.no_grad():
            surface_loss(control_points, inputs)

    return dict(
        full=elapsed_ms(backward(surface_loss), steps, device),
        forward=elapsed_ms(forward, steps, device),
        geometry=elapsed_ms(backward(ablated_loss), steps, device),
        rays=inputs.distortions_u.numel(),
    )


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--block-window", type=int, default=0, help="dynamic-window splat rows (0: the full splat)")
    parser.add_argument("--steps", type=int, default=15, help="timed calls of each variant")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    times = ablate(args.device, block_window=args.block_window or None, steps=args.steps)
    labels = (("full fwd+bwd", "full"), ("forward only", "forward"), ("fwd+bwd, trace+splat ablated", "geometry"))
    for label, key in labels:
        print(f"{label:30s} {times[key]:8.3f} ms   ({times['rays'] / times[key] / 1e3:8.1f} M rays/s)")
    print(f"\nbwd share              : {times['full'] - times['forward']:7.3f} ms")
    print(f"trace+splat share      : {times['full'] - times['geometry']:7.3f} ms")
    print(f"NURBS+alignment fwd+bwd: {times['geometry']:7.3f} ms")
    return times


if __name__ == "__main__":
    main()

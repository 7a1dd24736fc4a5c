"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``);
exits non-zero without them. It imports only ``torch``, ``numpy`` and the
``artist_tpu_torch`` package beside it, and runs in phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: every ``artist_tpu_torch/kernels/csrc/*.cu``, one ``nvcc`` each,
   all started together;
3. kernels, each against its plain PyTorch version on the card with the
   tolerances stated below, and timed with CUDA events beside its plain
   version, the one-call PyTorch yardstick (where there is one) and the
   card's bound for the same work:
   a. the splat pair at the surface step's chunk inputs (``[100, 40000]``
      rays onto ``[100, 256, 256]``) and on a batch of edge cases;
   b. the blocking sigma pair on the aim-point path's own first-epoch inputs
      (8 M rays, K = 16 candidates), on the same field with its rows 3 m
      apart, where the check must not be vacuous, and there with every
      candidate slot kept, at K = 16 and at K = 32; the arbiter is the plain
      version in float64;
4. surface step: the flagship surface-reconstruction step (100 heliostats,
   50 x 50 points per facet x 4 facets, 32 rays per point = 32 M rays,
   256 x 256 bitmaps, ray chunks of 4) built from the port's public
   functions, one warm-up and three timed ``torch.optim.Adam`` steps on the
   NURBS control points, with the kernels' launch counts asserted;
5. aim point (this slice's main path): ``AimPointOptimizer.optimize`` at
   ``bench.py``'s aim-point size (100 heliostats, 50 x 50 points per facet x
   4 facets, 8 rays per point = 8 M rays, field-wide blocking with K = 16),
   one warm-up and three timed epochs, launch counts asserted;
6. blocking step: the surface step of phase 4 with field-wide blocking on;
7. agreement: the small surface step and a small aim-point step on a packed
   dense-row field under a low receiver (at K = 16 and at K = 32, where some
   heliostat keeps more than 16 candidates), each on the card against the
   same step on the CPU.

Each driven path sets every launch count to 0 just before it and reads them
just after. Then one JSON line of per-kernel numbers and, last, the
``{"ok": true, ...}`` line. Any failure raises and the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import artist_tpu_torch  # noqa: E402
from artist_tpu_torch.field import heliostat_group as hg  # noqa: E402
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas  # noqa: E402
from artist_tpu_torch.flux.bitmap import trapezoid_distribution  # noqa: E402
from artist_tpu_torch.kernels import blocking as blocking_kernels  # noqa: E402
from artist_tpu_torch.kernels.build import build_all  # noqa: E402
from artist_tpu_torch.kernels.splat import LAUNCHES as SPLAT_LAUNCHES  # noqa: E402
from artist_tpu_torch.kernels.splat import reset_launch_counts as reset_splat_launch_counts  # noqa: E402
from artist_tpu_torch.kernels.splat import (  # noqa: E402
    splat_backward_cuda,
    splat_backward_plain,
    splat_forward_cuda,
    splat_forward_plain,
)
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces  # noqa: E402
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer  # noqa: E402
from artist_tpu_torch.optim.losses import kl_divergence_loss  # noqa: E402
from artist_tpu_torch.raytracing import geometry  # noqa: E402
from artist_tpu_torch.raytracing.blocking import create_blocking_primitives_rectangles_by_index  # noqa: E402
from artist_tpu_torch.raytracing.render import RenderConfig, ray_splat_inputs, trace_rays  # noqa: E402
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario  # noqa: E402
from artist_tpu_torch.util import constants  # noqa: E402

# The flagship configuration of bench.py's differentiable step.
HELIOSTATS = 100
SURFACE_POINTS = (50, 50)  # per facet, x 4 facets
RAYS = 32
RAY_CHUNK = 4
BITMAP = (256, 256)  # (width_e, height_u)
SEED = 7
STEPS = 3  # timed, after one warm-up
LEARNING_RATE = 1e-4

KERNELS = ("splat_forward", "splat_backward", "blocking_sigma_forward", "blocking_sigma_backward")
# Per step with RAY_CHUNK = 4: eight chunks, each splat forward run once in
# the forward pass and once more when checkpointing recomputes the chunk in
# the backward pass; one splat backward per chunk. With blocking on, the
# selective checkpoint saves sigma, so the recompute does not launch the sigma
# forward again: one sigma forward and one sigma backward per chunk.
CHUNKS = RAYS // RAY_CHUNK
LAUNCHES_PER_STEP = dict(zip(KERNELS, (2 * CHUNKS, CHUNKS, 0, 0)))
LAUNCHES_PER_BLOCKING_STEP = dict(zip(KERNELS, (2 * CHUNKS, CHUNKS, CHUNKS, CHUNKS)))

# The aim-point optimizer as bench.py:_bench_aim_point configures it.
AIM_HELIOSTATS = 100
AIM_SURFACE_POINTS = (50, 50)
AIM_RAYS = 8  # 100 x 10,000 points x 8 = 8 M rays per epoch, no ray chunks
AIM_CANDIDATES = 16
AIM_EPOCHS = 3  # timed, after one warm-up epoch
AIM_LEARNING_RATE = 1e-3
AIM_GAMMA = 0.99
DNI = 1000.0
# Per epoch: one forward and one backward of each kernel (no ray chunks);
# per optimize() call, one more forward of each for the epoch-0 references.
AIM_LAUNCHES_PER_EPOCH = dict.fromkeys(KERNELS, 1)
AIM_LAUNCHES_PER_CALL = dict(zip(KERNELS, (1, 0, 1, 0)))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s outside
# the tensor cores (the splat does no matrix work).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# fp32 operations per valid ray (floors and compares not counted):
# forward 2 fractions, 2 complements, 6 products, 4 atomic adds;
# backward 2 fractions, 2 complements, 13 for dw, 6 each for de and du.
FORWARD_FLOPS_PER_RAY = 14
BACKWARD_FLOPS_PER_RAY = 29
# fp32 operations per (ray, kept candidate) pair of the blocking sigma kernels,
# an exponential or a division counted as one operation (the card's SFU and
# division sequences take more instruction slots; the bound stays optimistic):
# forward: six 3-vector dots 30, reciprocal 1, t 2, the two projections 6,
# the two local coordinates 8, the five exponents' arguments 8, five
# exponentials 5, three gate denominators 7, sigma 3, the keep-weighted sum 2;
# backward: the forward's 70 before the sum, then base 2, the three gate
# slopes 11, the projection and t cotangents 12, o.n, d.n, d.u, d.v 6, the six
# ray cotangents 36, the 16 candidate cotangents 41, their sum over rays 16.
SIGMA_FORWARD_OPS_PER_PAIR = 72
SIGMA_BACKWARD_OPS_PER_PAIR = 194

# Kernel-vs-plain tolerances, in units of the fp32 rounding unit u = 2^-24.
# Forward: kernel and plain version add the same fp32 deposits (the products
# round identically), each pixel's in an order the atomics choose anew every
# run. A sum of n terms in any order is within (n - 1) u sum|terms| of the
# exact sum, so the two may differ by 2 (n - 1) u sum|terms| per pixel; the
# check takes n and sum|terms| per pixel from the run's own rays.
# Backward: a deterministic gather with the same formulas; nvcc contracts
# a*b + c into one FMA where PyTorch rounds twice, so each gradient may differ
# by a few roundings of its largest term. Allowed: 32 u x max|g| (dw) and
# 32 u x max|g| x max|w| (de, du).
UNIT_ROUNDOFF = 2.0**-24
BACKWARD_TOLERANCE = 32 * UNIT_ROUNDOFF

# The blocking sigma kernels against the plain version in float64 (the
# arbiter), on the same fp32 inputs. At softness 1000 the local coordinate
# u = (o.u + t d.u - c0.u) ... cancels terms of 1e2-1e3 m^2 down to order 1,
# so a few ulps of difference in u move a gate by k du: fp32 arithmetic,
# however correct, is off by up to percents at gate edges, and kernel and fp32
# plain version round differently (FMA contraction, summation order). The
# kernel is therefore held to the fp32 plain version's own error: for sigma,
# the mask and each cotangent (each candidate column separately), the max and
# the mean of |kernel - float64| may be at most ARBITER_FACTOR times those of
# |fp32 plain - float64|, plus a floor. The factor 2 leaves room for two
# independent roundings of the same ill-conditioned elements; the floor,
# 64 ulps of the output's largest magnitude plus 1e-30, covers outputs that
# the fp32 plain version happens to round exactly (an all-zero sigma on an
# unblocked field) and the subnormal tails of the saturated gates.
ARBITER_FACTOR = 2.0
ARBITER_FLOOR_ULPS = 64
ARBITER_FLOOR_ABSOLUTE = 1e-30


def _log(message: str) -> None:
    print(message, flush=True)


# The synthetic field puts its rows 12 m apart, and there nothing blocks; with
# rows 3 m apart most heliostats behind the front row are partly blocked.
DENSE_ROW_SPACING = 3.0


def row_positions(
    number_of_heliostats: int,
    row_spacing: float,
    columns: int | None = None,
    column_spacing: float = 8.0,
    first_row: float = 25.0,
) -> np.ndarray:
    """Heliostat positions ``[H, 4]`` of the synthetic field's grid with its rows
    ``row_spacing`` apart (``make_synthetic_scenario`` uses 12 m); by default its
    square grid of columns 8 m apart, the first row 25 m north of the tower."""
    if columns is None:
        columns = max(1, int(np.ceil(np.sqrt(number_of_heliostats))))
    index = np.arange(number_of_heliostats)
    east = (index % columns - (columns - 1) / 2) * column_spacing
    north = (index // columns) * row_spacing + first_row
    ones = np.ones(number_of_heliostats)
    return np.stack([east, north, 1.7 * ones, ones], axis=1).astype(np.float32)


@dataclass
class StepInputs:
    """Everything the flagship step reads besides the control points."""

    scenario: object
    active_indices: torch.Tensor  # [M]
    target_area_indices: torch.Tensor  # [M]
    incident_ray_directions: torch.Tensor  # [M, 4]
    aim_points: torch.Tensor  # [M, 4]
    distortions_u: torch.Tensor  # [M, R, P]
    distortions_e: torch.Tensor  # [M, R, P]
    ground_truth: torch.Tensor  # [M, H, W]
    surface_points_per_facet: tuple[int, int]
    config: RenderConfig


def step_inputs(
    scenario,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    surface_points_per_facet: tuple[int, int],
    bitmap_resolution: tuple[int, int],
    ray_chunk: int | None,
    blocking: bool = False,
) -> StepInputs:
    """The flagship step's inputs: every heliostat active, incident light from
    the south horizon ``[0, 1, 0, 0]``, target 0, aim point the target's
    centre, an all-ones ground truth; field-wide blocking (K = 16) if asked."""
    group = scenario.heliostat_groups[0]
    device = group.positions.device
    num = group.number_of_heliostats
    target_area_indices = torch.zeros(num, dtype=torch.long, device=device)
    return StepInputs(
        scenario=scenario,
        active_indices=torch.arange(num, device=device),
        target_area_indices=target_area_indices,
        incident_ray_directions=torch.tensor([0.0, 1.0, 0.0, 0.0], device=device).expand(num, 4),
        aim_points=get_centers_of_target_areas(scenario.solar_tower, target_area_indices),
        distortions_u=distortions_u,
        distortions_e=distortions_e,
        ground_truth=torch.ones((num, bitmap_resolution[1], bitmap_resolution[0]), device=device),
        surface_points_per_facet=surface_points_per_facet,
        config=RenderConfig(
            bitmap_resolution=bitmap_resolution, ray_chunk=ray_chunk, blocking_active=blocking
        ),
    )


def aligned_surfaces(control_points: torch.Tensor, inputs: StepInputs):
    """Control points -> NURBS surfaces -> alignment: ``[M, P, 4]`` points and normals."""
    group = inputs.scenario.heliostat_groups[0]
    active = hg.gather_active(
        group.replace(nurbs_control_points=control_points), inputs.active_indices
    )
    count = inputs.active_indices.shape[0]
    points, normals = evaluate_nurbs_surfaces(
        active.nurbs_control_points,
        group.nurbs_degrees,
        create_nurbs_evaluation_grid(
            inputs.surface_points_per_facet, device=control_points.device
        ),
        canting=active.canting,
        facet_translations=active.facet_translations,
    )
    active = active.replace(
        surface_points=points.reshape(count, -1, 4),
        surface_normals=normals.reshape(count, -1, 4),
    )
    return hg.align_surfaces_with_incident_ray_directions(
        active, inputs.aim_points, inputs.incident_ray_directions
    )[:2]


def render(control_points: torch.Tensor, inputs: StepInputs):
    """The step's forward render: ``trace_rays``'s flux and three factors.

    With blocking on, every heliostat's aligned surface is a blocker (its
    rectangle by corner index), as in ``bench.py:_build_step(blocking=True)``.
    """
    points, normals = aligned_surfaces(control_points, inputs)
    blocking = inputs.config.blocking_active
    return trace_rays(
        tower=inputs.scenario.solar_tower,
        aligned_surface_points=points,
        aligned_surface_normals=normals,
        incident_ray_directions=inputs.incident_ray_directions,
        target_area_indices=inputs.target_area_indices,
        distortions_u=inputs.distortions_u,
        distortions_e=inputs.distortions_e,
        blocking_primitives=create_blocking_primitives_rectangles_by_index(points) if blocking else None,
        ray_primitive_indices=inputs.active_indices if blocking else None,
        config=inputs.config,
    )


def surface_loss(control_points: torch.Tensor, inputs: StepInputs) -> torch.Tensor:
    """The flagship step's loss: the summed KL divergence over heliostats, over M."""
    flux = render(control_points, inputs)[0]
    num = inputs.active_indices.shape[0]
    return torch.sum(kl_divergence_loss(flux, inputs.ground_truth)) / num


def flagship_inputs(device: torch.device, blocking: bool = False) -> StepInputs:
    scenario = make_synthetic_scenario(
        number_of_heliostats=HELIOSTATS,
        number_of_surface_points_per_facet=SURFACE_POINTS,
        number_of_rays=RAYS,
        device=device,
    )
    group = scenario.heliostat_groups[0]
    generator = torch.Generator(device=device).manual_seed(SEED)
    distortions_u, distortions_e = scenario.light_sources[0].get_distortions(
        generator, group.surface_points.shape[1], group.number_of_heliostats
    )
    return step_inputs(
        scenario, distortions_u, distortions_e, SURFACE_POINTS, BITMAP, RAY_CHUNK, blocking
    )


def first_chunk_rays(inputs: StepInputs):
    """The splat's inputs in the main path's first ray chunk: ``[M, chunk * P]`` each."""
    group = inputs.scenario.heliostat_groups[0]
    chunk = inputs.config.ray_chunk
    with torch.no_grad():
        points, normals = aligned_surfaces(group.nurbs_control_points, inputs)
        preferred = geometry.reflect(inputs.incident_ray_directions[:, None, :], normals)
        rays = ray_splat_inputs(
            inputs.scenario.solar_tower,
            preferred,
            points,
            inputs.target_area_indices,
            inputs.distortions_u[:, :chunk],
            inputs.distortions_e[:, :chunk],
            1.0,
            inputs.config,
        )
    e, u, w = rays.bitmap_e, rays.bitmap_u, rays.final_intensities
    num = e.shape[0]
    return tuple(x.reshape(num, -1).contiguous() for x in (e, u, w))


def edge_case_rays(width: int, height: int, device: torch.device):
    """Integer, boundary (W-1, H-1), NaN, infinite, negative and zero-weight rays, plus random ones."""
    special = np.array(
        [
            (3.0, 5.0, 1.0),
            (0.0, 0.0, 0.7),
            (width - 2.0, height - 2.0, 1.2),
            (width - 2 + 0.5, height - 2 + 0.25, 0.9),
            (width - 1.0, 7.5, 1.0),
            (7.5, height - 1.0, 1.0),
            (-0.5, 3.5, 1.0),
            (3.5, -1e-3, 1.0),
            (np.nan, 4.5, 1.0),
            (4.5, np.nan, 1.0),
            (np.inf, 4.5, 1.0),
            (-np.inf, 4.5, 1.0),
            (1e30, 4.5, 1.0),
            (6.25, 7.75, 0.0),
            (100.0, 100.0, 0.0),
        ],
        dtype=np.float32,
    )
    rng = np.random.RandomState(SEED)
    num, extra = 3, 2000
    e = rng.uniform(-2, width + 2, (num, extra)).astype(np.float32)
    u = rng.uniform(-2, height + 2, (num, extra)).astype(np.float32)
    w = rng.rand(num, extra).astype(np.float32)
    e, u, w = (
        np.concatenate([np.tile(special[:, k], (num, 1)), x], axis=1)
        for k, x in enumerate((e, u, w))
    )
    return tuple(torch.tensor(x, device=device) for x in (e, u, w))


def event_ms(fn, iterations: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iterations`` back-to-back calls, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations


def _valid_taps(e, u, height, width):
    """Strict-bounds mask ``[M, N]`` and the flat bitmap ids of the 4 taps of the valid rays."""
    le, lu = torch.floor(e), torch.floor(u)
    valid = (le >= 0) & (le <= width - 2) & (lu >= 0) & (lu <= height - 2)
    base = torch.where(valid, lu * width + le, torch.zeros_like(e)).long()
    base = base + torch.arange(e.shape[0], device=e.device)[:, None] * (height * width)
    taps = torch.cat([base, base + 1, base + width, base + width + 1], dim=1)
    return valid, taps[valid.repeat(1, 4)]


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def check_splat_kernels(inputs: StepInputs) -> dict[str, dict]:
    """Phase 3a: each splat kernel against its plain version, then timed."""
    width, height = BITMAP
    device = inputs.ground_truth.device
    e, u, w = first_chunk_rays(inputs)
    g = torch.randn(
        (e.shape[0], height, width), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 1),
    )
    edge = edge_case_rays(width, height, device)
    edge_g = torch.randn(
        (edge[0].shape[0], height, width), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 2),
    )

    forward_err, backward_errs, worst_share = 0.0, [], 0.0
    for rays, cotangent in ((e, u, w), g), (edge, edge_g):
        kernel = splat_forward_cuda(*rays, height, width)
        plain = splat_forward_plain(*rays, height, width)
        _, taps = _valid_taps(rays[0], rays[1], height, width)
        deposits = torch.bincount(taps, minlength=plain.numel()).reshape(plain.shape)
        magnitude = splat_forward_plain(rays[0], rays[1], rays[2].abs(), height, width)
        limit = 2.01 * UNIT_ROUNDOFF * (deposits - 1).clamp(min=0) * magnitude
        difference = (kernel - plain).abs()
        if not bool((difference <= limit).all()):
            worst = int(torch.argmax(difference - limit))
            raise AssertionError(
                f"splat_forward: pixel {worst} differs by {float(difference.flatten()[worst])} "
                f"> {float(limit.flatten()[worst])} ({int(deposits.flatten()[worst])} deposits)"
            )
        forward_err = max(forward_err, float(difference.max()))
        worst_share = max(worst_share, float((difference / limit.clamp(min=1e-38)).max()))
        kernel_grads = splat_backward_cuda(*rays, cotangent, height, width)
        plain_grads = splat_backward_plain(*rays, cotangent, height, width)
        g_max = float(cotangent.abs().max())
        w_max = float(rays[2].abs().max())
        for name, k, p, scale in zip(
            ("de", "du", "dw"), kernel_grads, plain_grads, (g_max * w_max, g_max * w_max, g_max)
        ):
            err = _max_abs_err(k, p)
            if not err <= BACKWARD_TOLERANCE * scale:
                raise AssertionError(
                    f"splat_backward {name}: max |kernel - plain| {err} > {BACKWARD_TOLERANCE * scale}"
                )
            backward_errs.append(err)
            worst_share = max(worst_share, err / (BACKWARD_TOLERANCE * scale))
    torch.cuda.synchronize()
    # The edge cases: nothing from invalid rays, dw for zero-weight in-bounds rays.
    edge_flux = splat_forward_cuda(*edge, height, width)
    if not torch.isfinite(edge_flux).all():
        raise AssertionError("splat_forward: non-finite bitmap from NaN/inf rays")
    de, du, dw = splat_backward_cuda(*edge, edge_g, height, width)
    invalid = slice(4, 13)
    if not (de[:, invalid] == 0).all() or not (dw[:, invalid] == 0).all() or not (du[:, invalid] == 0).all():
        raise AssertionError("splat_backward: gradient on a ray outside the strict bounds")
    if not (dw[:, 13] != 0).all():
        raise AssertionError("splat_backward: zero-weight in-bounds ray lost its dw")

    num, rays_per_map = e.shape
    valid, taps = _valid_taps(e, u, height, width)
    num_valid = int(valid.sum())
    weights = torch.where(valid, w, torch.zeros_like(w))
    fe, fu = e - torch.floor(e), u - torch.floor(u)
    values = torch.cat(
        [weights * (1 - fu) * (1 - fe), weights * (1 - fu) * fe, weights * fu * (1 - fe), weights * fu * fe],
        dim=1,
    )[valid.repeat(1, 4)]
    touched = int(torch.unique(taps).numel())
    rays_total = num * rays_per_map
    map_bytes = 4 * num * height * width
    library_out = torch.zeros(num * height * width, device=device)

    timings = {
        "splat_forward": dict(
            ms=event_ms(lambda: splat_forward_cuda(e, u, w, height, width)),
            plain_ms=event_ms(lambda: splat_forward_plain(e, u, w, height, width)),
            library_ms=event_ms(lambda: library_out.index_add_(0, taps, values)),
            bound=bound_ms(8 * rays_total + 4 * num_valid + map_bytes, FORWARD_FLOPS_PER_RAY * num_valid),
            max_abs_err=forward_err,
            replaces="artist_tpu/kernels/splat_pallas.py:114 (_splat_fwd_kernel, via _splat_forward)",
        ),
        "splat_backward": dict(
            ms=event_ms(lambda: splat_backward_cuda(e, u, w, g, height, width)),
            plain_ms=event_ms(lambda: splat_backward_plain(e, u, w, g, height, width)),
            library_ms=None,
            bound=bound_ms(
                8 * rays_total + 4 * num_valid + 4 * touched + 12 * rays_total,
                BACKWARD_FLOPS_PER_RAY * num_valid,
            ),
            max_abs_err=max(backward_errs),
            replaces="artist_tpu/kernels/splat_pallas.py:168 (_splat_bwd_kernel, via _splat_bwd)",
        ),
    }
    _log(
        f"phase 3a splat kernels: [{num}, {rays_per_map}] rays ({num_valid} valid, {touched} pixels touched) "
        f"-> [{num}, {height}, {width}] and {edge[0].shape[1]} edge-case rays x {edge[0].shape[0]}, "
        f"worst error {worst_share:.3g} of its tolerance: "
        + "; ".join(
            f"{name} max_abs_err {t['max_abs_err']:.3g}, kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} ms, "
            f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]})"
            for name, t in timings.items()
        )
    )
    return timings


def reset_launch_counts() -> None:
    reset_splat_launch_counts()
    blocking_kernels.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {**SPLAT_LAUNCHES, **blocking_kernels.LAUNCHES}


def drive_surface_step(inputs: StepInputs, launches_per_step: dict[str, int], phase: str) -> dict:
    """One warm-up and STEPS timed Adam steps of the flagship surface step."""
    group = inputs.scenario.heliostat_groups[0]
    control_points = group.nurbs_control_points.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([control_points], lr=LEARNING_RATE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_seconds, losses = [], []
    for step in range(1 + STEPS):
        start = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss = surface_loss(control_points, inputs)
        loss.backward()
        grad = control_points.grad.detach().clone()
        optimizer.step()
        torch.cuda.synchronize()
        if step:
            step_seconds.append(time.perf_counter() - start)
        losses.append(loss.item())
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{phase}, step {step}: loss {losses[-1]} is not finite")
        if not torch.isfinite(grad).all() or not (grad != 0).any():
            raise AssertionError(f"{phase}, step {step}: control-point gradient not finite or all zero")
    launches = launch_counts()
    expected = {name: count * (1 + STEPS) for name, count in launches_per_step.items()}
    if launches != expected:
        raise AssertionError(f"{phase} launched {launches}, expected {expected}")
    rays = HELIOSTATS * RAYS * 4 * SURFACE_POINTS[0] * SURFACE_POINTS[1]
    mean_step = sum(step_seconds) / len(step_seconds)
    result = dict(
        launches=launches,
        step_seconds=step_seconds,
        rays_per_step=rays,
        rays_per_second=rays / mean_step,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        losses=losses,
    )
    _log(
        f"{phase}: {1 + STEPS} Adam steps (1 warm-up) of {rays} rays, "
        f"losses {losses}, step seconds {step_seconds} (mean {mean_step:.6f}), "
        f"{result['rays_per_second']:.6g} rays/s, max_memory_allocated "
        f"{result['max_memory_allocated']} B, launches {launches}"
    )
    return result


# --------------------------------------------------------------------------- #
# The aim-point path.
# --------------------------------------------------------------------------- #


class FixedDistortions:
    """A light source that hands out given sun distortions (numpy ``[H, R, P]``
    pairs) on the generator's device, so two runs can share them."""

    def __init__(self, number_of_rays: int, distortions_u: np.ndarray, distortions_e: np.ndarray):
        self.number_of_rays = number_of_rays
        self.distortions = (distortions_u, distortions_e)

    def get_distortions(self, generator, number_of_points: int, number_of_active_heliostats: int):
        return tuple(torch.tensor(x, device=generator.device) for x in self.distortions)


def aim_point_scenario(
    device,
    heliostats: int,
    surface_points,
    rays: int,
    row_spacing: float | None = None,
    receiver_height: float | None = None,
    **layout,
):
    """The synthetic field of the aim-point path, its rows ``row_spacing`` apart if
    given (``layout``: the other arguments of :func:`row_positions`), and its
    receiver's centre ``receiver_height`` m up if given (45 m otherwise)."""
    scenario = make_synthetic_scenario(
        number_of_heliostats=heliostats,
        number_of_surface_points_per_facet=surface_points,
        number_of_rays=rays,
        device=device,
    )
    if row_spacing is not None:
        group = scenario.heliostat_groups[0]
        positions = torch.tensor(row_positions(heliostats, row_spacing, **layout), device=device)
        scenario.heliostat_groups[0] = group.replace(positions=positions)
    if receiver_height is not None:
        tower = scenario.solar_tower
        centers = tower.planar_centers.clone()
        centers[:, 2] = receiver_height
        scenario.solar_tower = dataclasses.replace(tower, planar_centers=centers)
    return scenario


def aim_point_ground_truth(bitmap: tuple[int, int], device, slope: int = 30, plateau: int = 60) -> torch.Tensor:
    """``outer(trapezoid(height), trapezoid(width))``, as bench.py's aim-point entry."""
    vertical = trapezoid_distribution(bitmap[1], slope, plateau, device=device)
    horizontal = trapezoid_distribution(bitmap[0], slope, plateau, device=device)
    return torch.outer(vertical, horizontal)


def aim_point_optimizer(scenario, ground_truth, max_epoch: int, candidates: int, bitmap) -> AimPointOptimizer:
    """``bench.py:_bench_aim_point``'s optimizer: lr 1e-3, exponential decay 0.99,
    all three penalty weights 1, maximum flux density 1e6, incident light
    ``[0, 1, 0, 0]`` onto target 0 at a DNI of 1000."""
    configuration = {
        constants.optimization: {
            constants.initial_learning_rate: AIM_LEARNING_RATE,
            constants.tolerance: 0.0,
            constants.max_epoch: max_epoch,
            constants.batch_size: 96,
            constants.log_step: 0,
            constants.early_stopping_delta: 1e-9,
            constants.early_stopping_patience: 10_000,
            constants.early_stopping_window: 10_000,
        },
        constants.scheduler: {constants.scheduler_type: constants.exponential, constants.gamma: AIM_GAMMA},
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.rho_intercept: 1.0,
            constants.rho_local_flux: 1.0,
            constants.max_flux_density: 1e6,
        },
    }
    return AimPointOptimizer(
        scenario=scenario,
        optimization_configuration=configuration,
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        target_area_index=0,
        ground_truth=ground_truth.cpu().numpy(),
        dni=DNI,
        bitmap_resolution=bitmap,
        seed=SEED,
        blocking_candidates=candidates,
    )


class CaptureSigmaInputs(TorchDispatchMode):
    """Records the arguments of every blocking sigma operator call it sees."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.artist_tpu_torch.blocking_sigma.default:
            self.calls.append(args)
        return func(*args, **(kwargs or {}))


def first_epoch(optimizer: AimPointOptimizer):
    """``optimizer.objective()`` and its epoch-0 forward without gradient.

    Returns ``params``, ``loss_fn``, the forward's outputs (the target's flux,
    intercepts, on-target and blocking factors) and the sigma operator's own
    inputs in that forward, ``(tensors, (softness, offset, epsilon))``.
    """
    params, forward, loss_fn = optimizer.objective("kl_divergence")
    capture = CaptureSigmaInputs()
    with torch.no_grad(), capture:
        outputs = forward(params)
    (call,) = capture.calls
    return params, loss_fn, outputs, (tuple(call[:5]), tuple(call[5:]))


def _per_heliostat(fn, tensors, parameters, dtype, chunk: int = 10):
    """``fn`` over slices of the heliostat axis (float64 would not fit whole)."""
    parts = []
    for start in range(0, tensors[0].shape[0], chunk):
        parts.append(fn(*(x[start : start + chunk].to(dtype) for x in tensors), *parameters))
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(pieces) for pieces in zip(*parts))


def _arbitrate(what: str, kernel: torch.Tensor, plain: torch.Tensor, reference: torch.Tensor) -> float:
    """Hold the kernel to ARBITER_FACTOR x the fp32 plain version's error against
    float64, in max and in mean, plus the floor; returns the worst share of a limit."""
    kernel, plain = kernel.double(), plain.double()
    floor = ARBITER_FLOOR_ULPS * UNIT_ROUNDOFF * float(reference.abs().max()) + ARBITER_FLOOR_ABSOLUTE
    error_kernel, error_plain = (kernel - reference).abs(), (plain - reference).abs()
    worst = 0.0
    for statistic in ("max", "mean"):
        k = float(getattr(error_kernel, statistic)())
        limit = ARBITER_FACTOR * float(getattr(error_plain, statistic)()) + floor
        if not k <= limit:
            raise AssertionError(f"{what}: {statistic} |kernel - float64| {k} > {limit}")
        worst = max(worst, k / limit)
    return worst


def check_sigma_pair(label: str, inputs, parameters, gbar, alpha: float = 100.0) -> dict:
    """The sigma kernels against the plain version, fp32 and float64, on ``inputs``;
    the mask ``1 - exp(-alpha sigma)`` with the render's Beer-Lambert factor."""
    sigma = blocking_kernels.sigma_forward_cuda(*inputs, *parameters)
    grads = blocking_kernels.sigma_backward_cuda(*inputs, gbar, *parameters)
    torch.cuda.synchronize()
    plain = _per_heliostat(blocking_kernels.sigma_forward_plain, inputs, parameters, torch.float32)
    reference = _per_heliostat(blocking_kernels.sigma_forward_plain, inputs, parameters, torch.float64)
    plain_grads = _per_heliostat(
        blocking_kernels.sigma_backward_plain, inputs + (gbar,), parameters, torch.float32
    )
    reference_grads = _per_heliostat(
        blocking_kernels.sigma_backward_plain, inputs + (gbar,), parameters, torch.float64
    )
    worst = {
        "sigma": _arbitrate(f"{label} sigma", sigma, plain, reference),
        "mask": _arbitrate(
            f"{label} mask", 1.0 - torch.exp(-alpha * sigma), 1.0 - torch.exp(-alpha * plain),
            1.0 - torch.exp(-alpha * reference),
        ),
    }
    for name, k, p, r in zip(("origins", "directions"), grads, plain_grads, reference_grads):
        worst[name] = _arbitrate(f"{label} cotangent of {name}", k, p, r)
    worst["columns"] = max(
        _arbitrate(f"{label} cotangent of column {c}", grads[2][..., c], plain_grads[2][..., c], reference_grads[2][..., c])
        for c in range(blocking_kernels.NUM_COLUMNS)
    )
    blocked_share = float((1.0 - torch.exp(-alpha * reference) >= 1e-3).double().mean())
    return dict(
        worst_share=worst,
        forward_err=float((sigma - plain).abs().max()),
        backward_err=max(float((k - p).abs().max()) for k, p in zip(grads, plain_grads)),
        cotangent_scale=max(float(r.abs().max()) for r in reference_grads),
        sigma_max=float(reference.max()),
        blocked_share=blocked_share,
        kept_candidates=int(inputs[4].sum()),
    )


def time_sigma_pair(inputs, parameters, gbar) -> dict[str, dict]:
    """The sigma kernels' and plain versions' times on ``inputs``, and the card's
    bound for the same work: the kept pairs' operations or the bytes of every
    input read once and every output written once, whichever takes longer."""
    origins, directions, t_target, columns, keep = inputs
    num, points = origins.shape[:2]
    rays, candidates = directions.shape[1], columns.shape[1]
    pairs = rays * float(keep.sum())  # the kernels skip keep = 0 slots
    ray_bytes, point_bytes, candidate_bytes = num * rays, num * points, num * candidates
    # Forward: per ray, direction 16 and t_target 4 read, sigma 4 written; per
    # point, origin 16 read; per candidate, 16 columns 64 and keep 4 read.
    forward_bytes = 24 * ray_bytes + 16 * point_bytes + 68 * candidate_bytes
    # Backward: per ray, direction 16, t_target 4 and gbar 4 read, direction
    # cotangent 16 written; per point, origin 16 read and its cotangent 16
    # written; per candidate, columns 64 and keep 4 read, cotangents 64 written.
    backward_bytes = 40 * ray_bytes + 32 * point_bytes + 132 * candidate_bytes
    return {
        "blocking_sigma_forward": dict(
            ms=event_ms(lambda: blocking_kernels.sigma_forward_cuda(*inputs, *parameters)),
            plain_ms=event_ms(lambda: blocking_kernels.sigma_forward_plain(*inputs, *parameters), 3, 1),
            bound=bound_ms(forward_bytes, SIGMA_FORWARD_OPS_PER_PAIR * pairs),
            pairs=pairs,
        ),
        "blocking_sigma_backward": dict(
            ms=event_ms(lambda: blocking_kernels.sigma_backward_cuda(*inputs, gbar, *parameters)),
            plain_ms=event_ms(lambda: blocking_kernels.sigma_backward_plain(*inputs, gbar, *parameters), 3, 1),
            bound=bound_ms(backward_bytes, SIGMA_BACKWARD_OPS_PER_PAIR * pairs),
            pairs=pairs,
        ),
    }


def sigma_inputs(device: torch.device, row_spacing: float | None, candidates: int):
    """The sigma operator's inputs and parameters in the aim-point path's
    epoch-0 forward at full size, the field's rows ``row_spacing`` apart if given."""
    scenario = aim_point_scenario(device, AIM_HELIOSTATS, AIM_SURFACE_POINTS, AIM_RAYS, row_spacing)
    optimizer = aim_point_optimizer(scenario, aim_point_ground_truth(BITMAP, device), 0, candidates, BITMAP)
    return first_epoch(optimizer)[3]


# Phase 3b's inputs: (label, key in the kernel line, row spacing, K, every slot
# kept). The first is the aim-point path's own; the dense rows must block; with
# every slot kept, each ray meets K candidates (the operation-bound end of the
# kernels' range). At K = 32, where the TPU path splits its backward in two
# (its rows 11-12), the candidate order is also reversed: the corridor test
# ranks the nearest blockers first, so this puts them in slots 16-31, and a
# kernel that mishandled those slots would lose the blocking there.
SIGMA_CASES = (
    ("aim-point field", None, None, AIM_CANDIDATES, False),
    ("dense rows", "dense_rows", DENSE_ROW_SPACING, AIM_CANDIDATES, False),
    ("dense rows, all 16 slots kept", "all_kept", DENSE_ROW_SPACING, AIM_CANDIDATES, True),
    ("dense rows, all 32 slots kept, reversed", "all_kept_k32", DENSE_ROW_SPACING, 2 * AIM_CANDIDATES, True),
)


def check_blocking_kernels(device: torch.device) -> dict[str, dict]:
    """Phase 3b: the sigma kernels on the aim-point path's first-epoch inputs, on
    the same field with rows 3 m apart, and there with every candidate slot kept
    at K = 16 and K = 32; each held to the float64 arbiter and timed. The kernel
    table reports the first, the path's own."""
    results = {}
    for label, _, spacing, candidates, all_kept in SIGMA_CASES:
        inputs, parameters = sigma_inputs(device, spacing, candidates)
        if inputs[3].shape[1] != candidates:
            raise AssertionError(f"{label}: K = {inputs[3].shape[1]}, asked {candidates}")
        if all_kept:
            columns = inputs[3].flip(1).contiguous() if candidates > AIM_CANDIDATES else inputs[3]
            inputs = inputs[:3] + (columns, torch.ones_like(inputs[4]))
        gbar = torch.randn(
            inputs[2].shape, device=device, generator=torch.Generator(device=device).manual_seed(SEED + 3)
        )
        results[label] = check_sigma_pair(label, inputs, parameters, gbar)
        results[label]["timings"] = time_sigma_pair(inputs, parameters, gbar)
        results[label]["shape"] = (inputs[1].shape[0], inputs[1].shape[1], inputs[3].shape[1])
        del inputs, gbar
        torch.cuda.empty_cache()
    dense = results["dense rows"]
    if not (dense["sigma_max"] > 0.1 and dense["blocked_share"] > 0.05):
        raise AssertionError(
            f"dense rows: the check is vacuous (max sigma {dense['sigma_max']}, "
            f"blocked share {dense['blocked_share']})"
        )
    replaces = {
        "blocking_sigma_forward": "artist_tpu/kernels/blocking_pallas.py:240 (_sigma_forward_kernel, gated=True, pallas_call :883)",
        "blocking_sigma_backward": "artist_tpu/kernels/blocking_pallas.py:348 (_sigma_bwd_fused_kernel, pallas_call :930)",
    }
    errors = {"blocking_sigma_forward": "forward_err", "blocking_sigma_backward": "backward_err"}
    timings = {}
    for name, t in results[SIGMA_CASES[0][0]]["timings"].items():
        timings[name] = dict(
            t,
            library_ms=None,
            max_abs_err=max(r[errors[name]] for r in results.values()),
            replaces=replaces[name],
            **{
                key: {"ms": x["ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound"][0],
                      "bound_by": x["bound"][1], "pairs": x["pairs"], "candidates": candidates}
                for label, key, _, candidates, _ in SIGMA_CASES[1:]
                for x in (results[label]["timings"][name],)
            },
        )
    _log(
        "phase 3b blocking kernels: "
        + "; ".join(
            f"{label} ([{r['shape'][0]}, {r['shape'][1]}] rays x K = {r['shape'][2]}): max sigma "
            f"{r['sigma_max']:.4g}, blocked share {r['blocked_share']:.4g}, kept candidates "
            f"{r['kept_candidates']}, largest cotangent {r['cotangent_scale']:.4g}, worst share of the arbiter's limit "
            + json.dumps({k: round(v, 4) for k, v in r["worst_share"].items()})
            + ", "
            + ", ".join(
                f"{name} kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
                f"({t['bound'][1]}, {t['pairs']:.0f} kept pairs)"
                for name, t in r["timings"].items()
            )
            for label, r in results.items()
        )
        + "; max |kernel - fp32 plain|: "
        + ", ".join(f"{name} {t['max_abs_err']:.3g}" for name, t in timings.items())
    )
    return timings


def drive_aim_point(device: torch.device) -> dict:
    """Phase 5: AimPointOptimizer.optimize at bench.py's aim-point size, one warm-up
    and AIM_EPOCHS timed epochs, host clock around synchronised epochs."""
    scenario = aim_point_scenario(device, AIM_HELIOSTATS, AIM_SURFACE_POINTS, AIM_RAYS)
    optimizer = aim_point_optimizer(
        scenario, aim_point_ground_truth(BITMAP, device), AIM_EPOCHS, AIM_CANDIDATES, BITMAP
    )
    epoch_ends = []

    def on_epoch(epoch: int, loss: float) -> None:
        torch.cuda.synchronize()
        epoch_ends.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = time.perf_counter()
    loss, history, intercepts, _, blockings = optimizer.optimize("kl_divergence", on_epoch=on_epoch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    epochs = 1 + AIM_EPOCHS
    expected = {
        name: AIM_LAUNCHES_PER_EPOCH[name] * epochs + AIM_LAUNCHES_PER_CALL[name] for name in KERNELS
    }
    if launches != expected:
        raise AssertionError(f"aim-point path launched {launches}, expected {expected}")
    losses = history["total_loss"]
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"aim-point path: losses {losses}")
    motors = scenario.heliostat_groups[0].motor_positions
    moved = float((motors != optimizer.initial_motor_positions_all_groups[0]).double().mean())
    if not (torch.isfinite(motors).all() and moved > 0.5):
        raise AssertionError(f"aim-point path: motor gradient vanished ({moved} of the motors moved)")
    epoch_seconds = [b - a for a, b in zip(epoch_ends, epoch_ends[1:])]
    rays = AIM_HELIOSTATS * AIM_RAYS * 4 * AIM_SURFACE_POINTS[0] * AIM_SURFACE_POINTS[1]
    mean_epoch = sum(epoch_seconds) / len(epoch_seconds)
    result = dict(
        launches=launches,
        epoch_seconds=epoch_seconds,
        first_epoch_and_setup_seconds=epoch_ends[0] - start,
        optimize_seconds=seconds,
        rays_per_epoch=rays,
        rays_per_second=rays / mean_epoch,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        losses=losses,
        blocking_factor_mean=float(blockings.mean()),
        intercept_mean=float(intercepts.mean()),
        motors_moved=moved,
    )
    _log(
        f"phase 5 aim point: optimize() with {epochs} epochs (1 warm-up) of {rays} rays, K = {AIM_CANDIDATES}: "
        f"losses {losses}, timed epoch seconds {epoch_seconds} (mean {mean_epoch:.6f}), "
        f"{result['rays_per_second']:.6g} rays/s, setup + first epoch {result['first_epoch_and_setup_seconds']:.3f} s, "
        f"optimize() {seconds:.3f} s, max_memory_allocated {result['max_memory_allocated']} B, "
        f"mean blocking factor {result['blocking_factor_mean']:.6f}, mean intercept {result['intercept_mean']:.6f}, "
        f"motors moved {moved:.4f}, launches {launches}"
    )
    return result


SMALL = dict(heliostats=4, surface_points=(5, 5), rays=8, bitmap=(32, 32), ray_chunk=4)


def small_step(device: torch.device, distortions: np.ndarray, ground_truth: np.ndarray | None = None):
    """Flux, loss and control-point gradient of the step at the SMALL size on ``device``."""
    scenario = make_synthetic_scenario(
        number_of_heliostats=SMALL["heliostats"],
        number_of_surface_points_per_facet=SMALL["surface_points"],
        number_of_rays=SMALL["rays"],
        device=device,
    )
    du, de = (torch.tensor(x, device=device) for x in distortions)
    inputs = step_inputs(scenario, du, de, SMALL["surface_points"], SMALL["bitmap"], SMALL["ray_chunk"])
    if ground_truth is not None:
        inputs.ground_truth = torch.tensor(ground_truth, device=device)
    control_points = scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    loss = surface_loss(control_points, inputs)
    loss.backward()
    with torch.no_grad():
        flux = render(control_points, inputs)[0]
    return flux.cpu(), loss.item(), control_points.grad.cpu()


def check_small_step_against_cpu(device: torch.device) -> None:
    """Phase 7a: flux, loss and control-point gradient of a small step, ``device`` vs CPU.

    The CPU run takes the kernels' plain versions. The two differ by fp32
    rounding (atomic sum orders, fused multiply-adds, transcendental
    functions) through NURBS, alignment and the splat. Tolerances: flux 1e-4
    of its peak, loss rtol 1e-4, gradient 1e-3 of its largest entry. The
    gradient is taken under a ground truth of ones on the spot and zeros off
    it: under all ones, the KL gradient -p/q at a rim pixel holding one
    deposit of a ray ~1e-5 px from a cell edge turns ulp-level geometry
    differences into differences of tens of percent.
    """
    rng = np.random.RandomState(SEED)
    points = 4 * SMALL["surface_points"][0] * SMALL["surface_points"][1]
    # Wider than the sun's 2.1 mrad so the spot covers much of the small bitmap.
    distortions = rng.normal(0.0, 1e-2, (2, SMALL["heliostats"], SMALL["rays"], points)).astype(np.float32)
    flux_cpu, _, _ = small_step(torch.device("cpu"), distortions)
    spot = (flux_cpu > 0.05 * flux_cpu.amax(dim=(1, 2), keepdim=True)).float().numpy()
    results = [small_step(where, distortions, spot) for where in (device, torch.device("cpu"))]
    (flux_dev, loss_dev, grad_dev), (flux_cpu, loss_cpu, grad_cpu) = results
    flux_err = float((flux_dev - flux_cpu).abs().max())
    grad_err = float((grad_dev - grad_cpu).abs().max())
    checks = (
        (flux_err, 1e-4 * float(flux_cpu.abs().max()), "flux"),
        (abs(loss_dev - loss_cpu), 1e-4 * abs(loss_cpu), "loss"),
        (grad_err, 1e-3 * float(grad_cpu.abs().max()), "control-point gradient"),
    )
    for err, limit, what in checks:
        if not err <= limit:
            raise AssertionError(f"small step {what} differs between {device} and cpu: {err} > {limit}")
    if not float(grad_cpu.abs().max()) > 0:
        raise AssertionError("small step: zero control-point gradient")
    _log(
        f"phase 7a agreement: small surface step on {device} vs cpu: loss {loss_dev} vs {loss_cpu}; "
        + ", ".join(f"{what} max err {err:.3g} ({err / limit:.3g} of its limit)" for err, limit, what in checks)
    )


# The small aim-point step of the agreement phase: 48 heliostats in eight rows
# 3 m apart and six columns 3.5 m apart, the receiver's centre lowered to 10 m;
# 5 x 5 points per facet, 4 rays. The rays of a back-row heliostat then climb
# so slowly that they pass close over many heliostats, the corridor test keeps
# up to 20 candidates for a heliostat, and K = 32 fills slots 16-31 too.
# (Moving the field 250 m out instead keeps as many, but there fp32 rounding
# of the larger coordinates puts the card's flux more than 1e-4 of its peak
# from the CPU's.)
SMALL_AIM = dict(heliostats=48, surface_points=(5, 5), rays=4, bitmap=(64, 64))
SMALL_AIM_FIELD = dict(row_spacing=DENSE_ROW_SPACING, columns=6, column_spacing=3.5, receiver_height=10.0)


def small_aim_point_step(device: torch.device, candidates: int, distortions: np.ndarray, ground_truth=None):
    """The target's flux, the loss and the motor gradient of the first aim-point
    epoch on the SMALL_AIM field on ``device``; and the keep flags ``[M, K]`` of
    the candidates the sigma operator saw."""
    scenario = aim_point_scenario(
        device, SMALL_AIM["heliostats"], SMALL_AIM["surface_points"], SMALL_AIM["rays"], **SMALL_AIM_FIELD
    )
    scenario.light_sources[0] = FixedDistortions(SMALL_AIM["rays"], *distortions)
    truth = torch.ones(SMALL_AIM["bitmap"][::-1], device=device) if ground_truth is None else ground_truth.to(device)
    optimizer = aim_point_optimizer(scenario, truth, 0, candidates, SMALL_AIM["bitmap"])
    params, loss_fn, (flux, intercepts, _, _), (inputs, _) = first_epoch(optimizer)
    references = (torch.sum(flux), intercepts)
    zero = torch.zeros((), device=device)
    params[0].requires_grad_(True)
    loss, _ = loss_fn(params, references, (zero, zero, zero))
    loss.backward()
    return flux.cpu(), loss.item(), params[0].grad.cpu(), inputs[4].cpu()


def check_small_aim_point_against_cpu(device: torch.device) -> dict[int, dict]:
    """Phase 7b: the first aim-point epoch on the SMALL_AIM field, ``device`` vs
    CPU, at K = 16 and at K = 32 (the TPU path splits its backward in two above
    16). At K = 32 some heliostat must keep a candidate in slots 16-31.

    The CPU run takes the kernels' plain versions. The tolerances are the
    surface step's: loss rtol 1e-4, flux 1e-4 of its peak, motor gradient
    1e-3 of its largest entry, under a ground truth of ones on the CPU's spot
    and zeros off it. The gates at softness 1000 turn ulp-level differences in
    ray geometry into differences of up to percents in the mask of the few
    rays that graze a blocker's edge, but those rays are too few to move the
    flux or the gradient by more than that.
    """
    rng = np.random.RandomState(SEED + 5)
    points = 4 * SMALL_AIM["surface_points"][0] * SMALL_AIM["surface_points"][1]
    shape = (SMALL_AIM["heliostats"], SMALL_AIM["rays"], points)
    distortions = rng.normal(0.0, 2e-3, (2,) + shape).astype(np.float32)
    results = {}
    for candidates in (AIM_CANDIDATES, 2 * AIM_CANDIDATES):
        flux_cpu = small_aim_point_step(torch.device("cpu"), candidates, distortions)[0]
        spot = (flux_cpu > 0.05 * flux_cpu.max()).float()
        reset_launch_counts()
        flux_dev, loss_dev, grad_dev, keep_dev = small_aim_point_step(device, candidates, distortions, spot)
        launches = launch_counts()
        flux_cpu, loss_cpu, grad_cpu, keep_cpu = small_aim_point_step(torch.device("cpu"), candidates, distortions, spot)
        if device.type == "cuda" and not (launches["blocking_sigma_forward"] and launches["blocking_sigma_backward"]):
            raise AssertionError(f"small aim-point step at K = {candidates}: no sigma kernel launched ({launches})")
        if not keep_dev.shape[1] == keep_cpu.shape[1] == candidates:
            raise AssertionError(
                f"small aim-point step: K = {keep_dev.shape[1]} on {device}, {keep_cpu.shape[1]} on cpu, asked {candidates}"
            )
        kept_beyond_16 = int(keep_dev[:, AIM_CANDIDATES:].sum())
        if candidates > AIM_CANDIDATES and not kept_beyond_16 > 0:
            raise AssertionError(f"small aim-point step at K = {candidates}: no candidate kept in slots 16-{candidates - 1}")
        checks = (
            (abs(loss_dev - loss_cpu), 1e-4 * abs(loss_cpu), "loss"),
            (float((flux_dev - flux_cpu).abs().max()), 1e-4 * float(flux_cpu.abs().max()), "flux"),
            (float((grad_dev - grad_cpu).abs().max()), 1e-3 * float(grad_cpu.abs().max()), "motor gradient"),
        )
        for err, limit, what in checks:
            if not err <= limit:
                raise AssertionError(
                    f"small aim-point step at K = {candidates}: {what} differs between {device} and cpu: {err} > {limit}"
                )
        if not float(grad_cpu.abs().max()) > 0:
            raise AssertionError("small aim-point step: zero motor gradient")
        results[candidates] = {what: (err, limit) for err, limit, what in checks}
        results[candidates]["kept_beyond_16"] = kept_beyond_16
        _log(
            f"phase 7b agreement: small aim-point step at K = {candidates} on {device} vs cpu: loss {loss_dev} vs "
            f"{loss_cpu}; "
            + ", ".join(f"{what} max err {err:.3g} ({err / limit:.3g} of its limit)" for err, limit, what in checks)
            + f"; most candidates kept by one heliostat {int(keep_dev.sum(dim=1).max())}, "
            f"kept in slots 16 and up {kept_beyond_16}; launches {launches}"
        )
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if pathlib.Path(artist_tpu_torch.__file__).resolve().parent != REPO / "artist_tpu_torch":
        print("chip_smoke: artist_tpu_torch must sit beside this script", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    _log(f"phase 1 device: {name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, TF32 off")
    _log(smi)

    start = time.perf_counter()
    built = build_all()
    build_seconds = time.perf_counter() - start
    report = "; ".join(
        f"{path.name}: " + " | ".join(line.strip() for line in output.splitlines() if "registers" in line)
        for path, output in built.values()
    )
    _log(f"phase 2 build: {len(built)} sources in {build_seconds:.2f} s; ptxas: {report}")

    inputs = flagship_inputs(device)
    timings = check_splat_kernels(inputs)
    timings.update(check_blocking_kernels(device))
    torch.cuda.empty_cache()
    paths = {"surface_step": drive_surface_step(inputs, LAUNCHES_PER_STEP, "phase 4 surface step")}
    del inputs
    torch.cuda.empty_cache()
    paths["aim_point"] = drive_aim_point(device)
    torch.cuda.empty_cache()
    paths["blocking_step"] = drive_surface_step(
        flagship_inputs(device, blocking=True), LAUNCHES_PER_BLOCKING_STEP, "phase 6 blocking step"
    )
    torch.cuda.empty_cache()
    check_small_step_against_cpu(device)
    check_small_aim_point_against_cpu(device)

    kernels = []
    for kernel_name, t in timings.items():
        kernels.append(
            {
                "name": kernel_name,
                "route": "cuda",
                "source": f"artist_tpu_torch/kernels/csrc/{kernel_name.split('_')[0]}.cu",
                "replaces": t["replaces"],
                # This slice's main path is the aim-point optimizer (phase 5).
                "launches": paths["aim_point"]["launches"][kernel_name],
                "launches_by_path": {path: r["launches"][kernel_name] for path, r in paths.items()},
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
                **{key: t[key] for _, key, *_ in SIGMA_CASES[1:] if key in t},
            }
        )
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``);
exits non-zero without them. It imports only ``torch``, ``numpy`` and the
``artist_tpu_torch`` package beside it, and runs in phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: the splat kernels from ``artist_tpu_torch/kernels/csrc/splat.cu``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's own chunk inputs (``[100, 40000]`` rays onto ``[100, 256, 256]``)
   and on a batch of edge cases, with the tolerances stated below; each timed
   with CUDA events beside its plain version, the one-call PyTorch yardstick
   and the card's bound for the same work;
4. main path: the flagship surface-reconstruction step (100 heliostats,
   50 x 50 points per facet x 4 facets, 32 rays per point = 32 M rays,
   256 x 256 bitmaps, ray chunks of 4) built from the port's public
   functions, one warm-up and three timed ``torch.optim.Adam`` steps on the
   NURBS control points, with the kernels' launch counts asserted;
5. agreement: a small step on the card against the same step on the CPU.

Then one JSON line of per-kernel numbers and, last, the ``{"ok": true, ...}``
line. Any failure raises and the script exits non-zero.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import artist_tpu_torch  # noqa: E402
from artist_tpu_torch.field import heliostat_group as hg  # noqa: E402
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas  # noqa: E402
from artist_tpu_torch.kernels.splat import (  # noqa: E402
    LAUNCHES,
    build_library,
    reset_launch_counts,
    splat_backward_cuda,
    splat_backward_plain,
    splat_forward_cuda,
    splat_forward_plain,
)
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces  # noqa: E402
from artist_tpu_torch.optim.losses import kl_divergence_loss  # noqa: E402
from artist_tpu_torch.raytracing.render import RenderConfig, ray_splat_inputs, trace_rays  # noqa: E402
from artist_tpu_torch.raytracing import geometry  # noqa: E402
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario  # noqa: E402

# The flagship configuration of bench.py's differentiable step.
HELIOSTATS = 100
SURFACE_POINTS = (50, 50)  # per facet, x 4 facets
RAYS = 32
RAY_CHUNK = 4
BITMAP = (256, 256)  # (width_e, height_u)
SEED = 7
STEPS = 3  # timed, after one warm-up
LEARNING_RATE = 1e-4

# Per step with RAY_CHUNK = 4: eight chunks, each forward kernel run once in
# the forward pass and once more when checkpointing recomputes the chunk in
# the backward pass; one backward kernel per chunk.
LAUNCHES_PER_STEP = {"splat_forward": 2 * RAYS // RAY_CHUNK, "splat_backward": RAYS // RAY_CHUNK}

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s outside
# the tensor cores (the splat does no matrix work).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# fp32 operations per valid ray (floors and compares not counted):
# forward 2 fractions, 2 complements, 6 products, 4 atomic adds;
# backward 2 fractions, 2 complements, 13 for dw, 6 each for de and du.
FORWARD_FLOPS_PER_RAY = 14
BACKWARD_FLOPS_PER_RAY = 29

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


def _log(message: str) -> None:
    print(message, flush=True)


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
) -> StepInputs:
    """The flagship step's inputs: every heliostat active, incident light from
    the south horizon ``[0, 1, 0, 0]``, target 0, aim point the target's
    centre, an all-ones ground truth."""
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
        config=RenderConfig(bitmap_resolution=bitmap_resolution, ray_chunk=ray_chunk),
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
    """The step's forward render: ``trace_rays``'s flux and three factors."""
    points, normals = aligned_surfaces(control_points, inputs)
    return trace_rays(
        tower=inputs.scenario.solar_tower,
        aligned_surface_points=points,
        aligned_surface_normals=normals,
        incident_ray_directions=inputs.incident_ray_directions,
        target_area_indices=inputs.target_area_indices,
        distortions_u=inputs.distortions_u,
        distortions_e=inputs.distortions_e,
        config=inputs.config,
    )


def surface_loss(control_points: torch.Tensor, inputs: StepInputs) -> torch.Tensor:
    """The flagship step's loss: the summed KL divergence over heliostats, over M."""
    flux = render(control_points, inputs)[0]
    num = inputs.active_indices.shape[0]
    return torch.sum(kl_divergence_loss(flux, inputs.ground_truth)) / num


def flagship_inputs(device: torch.device) -> StepInputs:
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
    return step_inputs(scenario, distortions_u, distortions_e, SURFACE_POINTS, BITMAP, RAY_CHUNK)


def first_chunk_rays(inputs: StepInputs):
    """The splat's inputs in the main path's first ray chunk: ``[M, chunk * P]`` each."""
    group = inputs.scenario.heliostat_groups[0]
    chunk = inputs.config.ray_chunk
    with torch.no_grad():
        points, normals = aligned_surfaces(group.nurbs_control_points, inputs)
        preferred = geometry.reflect(inputs.incident_ray_directions[:, None, :], normals)
        e, u, _, w = ray_splat_inputs(
            inputs.scenario.solar_tower,
            preferred,
            points,
            inputs.target_area_indices,
            inputs.distortions_u[:, :chunk],
            inputs.distortions_e[:, :chunk],
            1.0,
            inputs.config,
        )
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


def check_kernels(inputs: StepInputs) -> dict[str, dict]:
    """Phase 3: each kernel against its plain version, then timed."""
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
        f"phase 3 kernels: [{num}, {rays_per_map}] rays ({num_valid} valid, {touched} pixels touched) "
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


def drive_main_path(inputs: StepInputs) -> dict:
    """Phase 4: one warm-up and STEPS timed Adam steps of the flagship step."""
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
            raise AssertionError(f"step {step}: loss {losses[-1]} is not finite")
        if not torch.isfinite(grad).all() or not (grad != 0).any():
            raise AssertionError(f"step {step}: control-point gradient not finite or all zero")
    launches = dict(LAUNCHES)
    expected = {name: count * (1 + STEPS) for name, count in LAUNCHES_PER_STEP.items()}
    if launches != expected:
        raise AssertionError(f"main path launched {launches}, expected {expected}")
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
        f"phase 4 main path: {1 + STEPS} Adam steps (1 warm-up) of {rays} rays, "
        f"losses {losses}, step seconds {step_seconds} (mean {mean_step:.6f}), "
        f"{result['rays_per_second']:.6g} rays/s, max_memory_allocated "
        f"{result['max_memory_allocated']} B, launches {launches}"
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
    """Phase 5: flux, loss and control-point gradient of a small step, ``device`` vs CPU.

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
        f"phase 5 agreement: small step on {device} vs cpu: loss {loss_dev} vs {loss_cpu}; "
        + ", ".join(f"{what} max err {err:.3g} ({err / limit:.3g} of its limit)" for err, limit, what in checks)
    )


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
    library, compiler_output = build_library()
    build_seconds = time.perf_counter() - start
    registers = [line.strip() for line in compiler_output.splitlines() if "registers" in line]
    _log(f"phase 2 build: {build_seconds:.2f} s, {library.name}; ptxas: {' | '.join(registers)}")

    inputs = flagship_inputs(device)
    timings = check_kernels(inputs)
    main_path = drive_main_path(inputs)
    check_small_step_against_cpu(device)

    kernels = []
    for kernel_name, t in timings.items():
        kernels.append(
            {
                "name": kernel_name,
                "route": "cuda",
                "source": "artist_tpu_torch/kernels/csrc/splat.cu",
                "replaces": t["replaces"],
                "launches": main_path["launches"][kernel_name],
                "launches_per_step": LAUNCHES_PER_STEP[kernel_name],
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"],
                "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            }
        )
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The flagship differentiable step: control points -> NURBS -> alignment -> trace -> KL.

The step that ``bench.py:_build_step`` builds (100 heliostats, 50 x 50 points per
facet x 4 facets, 32 rays a point, 256 x 256 bitmaps, ray chunks of 4; light from
the south horizon onto target 0, an all-ones ground truth), built from the port's
public functions. ``chip_smoke.py``, ``profile_torch_step.py`` and the tools
:mod:`~artist_tpu_torch.tools.ablate_step` and
:mod:`~artist_tpu_torch.tools.memory_report` import it from here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.optim.losses import kl_divergence_loss
from artist_tpu_torch.parallel.microbatch import chunked_map, chunked_sum
from artist_tpu_torch.raytracing.blocking import create_blocking_primitives_rectangles_by_index
from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario

# bench.py's defaults.
HELIOSTATS = 100
SURFACE_POINTS = (50, 50)  # per facet, x 4 facets
RAYS = 32
RAY_CHUNK = 4
BITMAP = (256, 256)  # (width_e, height_u)
SEED = 7
LEARNING_RATE = 1e-4
CANDIDATES = 16  # blocking candidates a heliostat on the compacted route
# bench.py's BENCH_SPLAT_BLOCK_WINDOW=96: the dynamic-window splat, its ray blocks
# cut point-major over 10 x 10 tiles of each facet's points.
BLOCK_WINDOW = dict(splat_block_window=96, splat_point_layout=(50, 50, 4), splat_point_tile=10)


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
    # Heliostats a checkpointed chunk of the step (bench.py's heliostat_chunk); None: no chunks.
    heliostat_chunk: int | None = None


def step_inputs(
    scenario,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    surface_points_per_facet: tuple[int, int],
    bitmap_resolution: tuple[int, int],
    ray_chunk: int | None,
    blocking: bool = False,
    candidates: int | None = CANDIDATES,
    heliostat_chunk: int | None = None,
) -> StepInputs:
    """The flagship step's inputs: every heliostat active, incident light from
    the south horizon ``[0, 1, 0, 0]``, target 0, aim point the target's
    centre, an all-ones ground truth; field-wide blocking if asked, on the
    compacted route with ``candidates`` per heliostat or, with None, the flat
    one; the heliostat axis in checkpointed chunks of ``heliostat_chunk``."""
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
            bitmap_resolution=bitmap_resolution, ray_chunk=ray_chunk, blocking_active=blocking,
            blocking_candidates=candidates,
        ),
        heliostat_chunk=heliostat_chunk,
    )


def _take(x: torch.Tensor, indices: torch.Tensor | None) -> torch.Tensor:
    """Rows ``indices`` of a per-heliostat tensor; all of it for None."""
    return x if indices is None else x.index_select(0, indices)


def aligned_surfaces(control_points: torch.Tensor, inputs: StepInputs, indices: torch.Tensor | None = None):
    """Control points -> NURBS surfaces -> alignment: ``[M, P, 4]`` points and normals,
    of the heliostats ``indices`` (positions in ``inputs.active_indices``; None: all)."""
    group = inputs.scenario.heliostat_groups[0]
    active = hg.gather_active(
        group.replace(nurbs_control_points=control_points), _take(inputs.active_indices, indices)
    )
    count = active.positions.shape[0]
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
        active, _take(inputs.aim_points, indices), _take(inputs.incident_ray_directions, indices)
    )[:2]


def render(
    control_points: torch.Tensor,
    inputs: StepInputs,
    indices: torch.Tensor | None = None,
    primitives: tuple[torch.Tensor, ...] | None = None,
):
    """The step's forward render: ``trace_rays``'s flux and three factors, of the
    heliostats ``indices`` (None: all).

    With blocking on, every heliostat's aligned surface is a blocker (its
    rectangle by corner index), as in ``bench.py:_build_step(blocking=True)``:
    ``primitives`` are the whole field's when given, else those of the
    heliostats rendered.
    """
    points, normals = aligned_surfaces(control_points, inputs, indices)
    blocking = inputs.config.blocking_active
    if blocking and primitives is None:
        primitives = create_blocking_primitives_rectangles_by_index(points)
    return trace_rays(
        tower=inputs.scenario.solar_tower,
        aligned_surface_points=points,
        aligned_surface_normals=normals,
        incident_ray_directions=_take(inputs.incident_ray_directions, indices),
        target_area_indices=_take(inputs.target_area_indices, indices),
        distortions_u=_take(inputs.distortions_u, indices),
        distortions_e=_take(inputs.distortions_e, indices),
        blocking_primitives=primitives if blocking else None,
        ray_primitive_indices=_take(inputs.active_indices, indices) if blocking else None,
        config=inputs.config,
    )


def surface_loss(control_points: torch.Tensor, inputs: StepInputs) -> torch.Tensor:
    """The flagship step's loss: the summed KL divergence over heliostats, over M.

    With ``inputs.heliostat_chunk`` it is ``bench.py:_build_step``'s chunked
    loss: phase 1 maps each chunk to its 4-corner primitives (with blocking
    on), phase 2 sums each chunk's KL sum, traced against the whole field's
    primitives; each chunk runs under a checkpoint, NURBS and alignment
    included.
    """
    num = inputs.active_indices.shape[0]
    chunk = inputs.heliostat_chunk
    if not chunk:
        flux = render(control_points, inputs)[0]
        return torch.sum(kl_divergence_loss(flux, inputs.ground_truth)) / num
    positions = torch.arange(num, device=control_points.device)
    primitives = None
    if inputs.config.blocking_active:
        primitives = chunked_map(
            lambda idx: create_blocking_primitives_rectangles_by_index(
                aligned_surfaces(control_points, inputs, idx)[0]
            ),
            positions,
            chunk,
        )

    def kl_sum(idx: torch.Tensor) -> torch.Tensor:
        flux = render(control_points, inputs, idx, primitives)[0]
        return torch.sum(kl_divergence_loss(flux, inputs.ground_truth.index_select(0, idx)))

    return chunked_sum(kl_sum, positions, chunk) / num


def field_inputs(
    device: torch.device | str,
    heliostats: int = HELIOSTATS,
    surface_points: tuple[int, int] = SURFACE_POINTS,
    rays: int = RAYS,
    bitmap: tuple[int, int] = BITMAP,
    ray_chunk: int | None = RAY_CHUNK,
    blocking: bool = False,
    candidates: int | None = CANDIDATES,
    heliostat_chunk: int | None = None,
    seed: int = SEED,
) -> StepInputs:
    """The step's inputs on the synthetic field of ``heliostats`` at the given widths,
    its sun distortions drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    scenario = make_synthetic_scenario(
        number_of_heliostats=heliostats,
        number_of_surface_points_per_facet=surface_points,
        number_of_rays=rays,
        device=device,
    )
    group = scenario.heliostat_groups[0]
    generator = torch.Generator(device=device).manual_seed(seed)
    distortions_u, distortions_e = scenario.light_sources[0].get_distortions(
        generator, group.surface_points.shape[1], group.number_of_heliostats
    )
    return step_inputs(
        scenario, distortions_u, distortions_e, surface_points, bitmap, ray_chunk, blocking, candidates,
        heliostat_chunk,
    )


def flagship_inputs(
    device: torch.device | str, blocking: bool = False, candidates: int | None = CANDIDATES, **splat_options
) -> StepInputs:
    """The flagship step's inputs; ``splat_options`` (``BLOCK_WINDOW``) go into its RenderConfig."""
    inputs = field_inputs(device, blocking=blocking, candidates=candidates)
    return dataclasses.replace(inputs, config=dataclasses.replace(inputs.config, **splat_options))


def adam_step(inputs: StepInputs, learning_rate: float = LEARNING_RATE):
    """One step of the flagship step on ``inputs`` as a function of no arguments: the
    loss, its backward and Adam on a copy of the group's control points."""
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([control_points], lr=learning_rate)

    def step() -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = surface_loss(control_points, inputs)
        loss.backward()
        optimizer.step()
        return loss

    return step

"""Differentiable render: scatter -> intersect -> block -> splat.

Counterpart of ``artist_tpu/raytracing/render.py``. Memory is bounded by a
loop over ray chunks; each chunk runs under
``torch.utils.checkpoint(..., use_reentrant=False)`` (unless
``remat_chunks=False``) so the backward
recomputes the chunk's forward (splat kernel included) instead of storing
its per-ray tensors - the port of the JAX package's remat'd ``lax.scan``.
With blocking on, the checkpoint is selective: the outputs of the blocking
sigma operators and of the flat route's cull are saved, so the recompute
does not launch their kernels again (the JAX package's
``save_only_these_names("blocking_sigma")`` policy, and a cull that is not
run twice). The distortion scatter uses the fused component-wise rotation
and never builds ``[M, R, P, 4, 4]`` rotation tensors.

Kernel launches per checkpointed ray chunk, forward and backward: two splat
forwards (the recompute runs it again) and one splat backward, of the
dynamic-window kernels with ``splat_block_window`` set and of the full splat
otherwise (``splat_window`` wraps the full splat at window size). The
dynamic-window kernels take the chunk's ``[M, r, P]`` streams as they are and
cut their ray blocks through the point order (``point_permutation``), so
no ray stream is reordered or copied for them; with
blocking on the compacted route (``blocking_candidates`` set) one sigma
forward and one sigma backward; on the flat route
(``blocking_candidates=None``) one cull, one flat sigma forward and one
flat sigma backward. Without ray chunks, or with ``remat_chunks=False``, there
is no recompute: one launch of each forward and backward kernel per chunk.

Planar and cylindrical target areas: a tower with one kind runs its
intersection alone; a mixed tower runs both on every heliostat and selects
per heliostat by its target's kind.

On a tower of planar target areas with blocking off, the chain from the scatter
angles to the splat's inputs (``ray_splat_inputs``' rotation, intersection and
intensities) is the ray kernel pair of :mod:`artist_tpu_torch.kernels.rays`,
which keeps no per-ray tensor: per checkpointed chunk two ray forwards and one
ray backward, as for the splat. With blocking on the compacted route
(``blocking_candidates`` set) on such a tower, the chain around the sigma pair is
the kernels of :mod:`artist_tpu_torch.kernels.blocked_rays`
(:func:`blocked_splat_inputs`), which keep per ray only what the sigma pair
reads and the splat's inputs: per checkpointed chunk each of their forwards
twice and each backward once; that module is imported only there. The flat
blocking route and cylindrical targets take ``ray_splat_inputs``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.geometry.transforms import apply_distortion_rotation
from artist_tpu_torch.kernels.blocking import blocking_sigma
from artist_tpu_torch.kernels.rays import ray_chunk
from artist_tpu_torch.kernels.splat_window import splat_dynamic_window
from artist_tpu_torch.raytracing import blocking, geometry
from artist_tpu_torch.raytracing.blocking import soft_ray_blocking_mask
from artist_tpu_torch.raytracing.splatting import bilinear_splat, point_tile_order
from artist_tpu_torch.util.logging_utils import span

DEFAULT_MIRROR_REFLECTIVITY = 0.935


@dataclass(frozen=True)
class RenderConfig:
    """Render configuration."""

    bitmap_resolution: tuple[int, int] = (256, 256)  # (width_e, height_u)
    mirror_reflectivity: float = DEFAULT_MIRROR_REFLECTIVITY
    ray_extinction_factor: float = 0.0
    # Chunk size along the ray axis (None = all). Each chunk is recomputed in
    # the backward instead of storing its per-ray tensors: O(chunk) instead of
    # O(rays) activation memory.
    ray_chunk: int | None = None
    # The JAX package's choice of TPU formulation for the splat and (below) for
    # blocking ("auto", "pallas", "xla", ...). Accepted and ignored: the port
    # always computes the semantics of the JAX package's Pallas routes, with
    # its own kernels on the card and their plain versions on the CPU.
    splat_method: str = "auto"
    # Per-heliostat splat window (pixels) at the intensity-weighted spot
    # centre; rays outside it are dropped. None = the full-bitmap splat.
    splat_window: int | None = None
    # Exact per-ray-block row window (pixels, a multiple of 8): each block of
    # rays splats through a window at its own deposit offset, a block that
    # exceeds it into the full map. The blocks are cut from the rays taken
    # point-major over spatial point tiles, so that they have compact spans;
    # the kernels read the rays in place through that order. Takes precedence
    # over splat_window. None = the full-bitmap splat.
    splat_block_window: int | None = None
    # Spatial tile edge of the point order (splat_block_window only).
    splat_point_tile: int = 10
    # Surface-point grid layout (points_u, points_v, facets) of the tile
    # order; None takes the points in index order (plain point-major).
    splat_point_layout: tuple[int, int, int] | None = None
    # Field-wide soft blocking; needs the blocking primitives.
    blocking_active: bool = False
    # Chunk of the blocking-primitive axis, passed to soft_ray_blocking_mask
    # (which accepts it and computes the same mask without it).
    primitive_chunk: int | None = None
    blocking_method: str = "auto"
    # Candidate blockers per heliostat (K) of the compacted blocking route.
    # None selects the flat route over every primitive, with the AABB cull.
    blocking_candidates: int | None = 16
    # Recompute each ray chunk in the backward instead of storing its
    # residuals (O(chunk) instead of O(rays) activation memory). False keeps
    # every chunk's residuals: no recompute, one splat forward fewer a chunk.
    remat_chunks: bool = True


class ChunkRays(NamedTuple):
    """One chunk of rays from scatter to the splat's inputs, each ``[M, r, P]``
    (``ray_directions`` ``[M, r, P, 4]``)."""

    ray_directions: torch.Tensor
    bitmap_e: torch.Tensor
    bitmap_u: torch.Tensor
    distances: torch.Tensor  # to the target hit; 0 for rays that miss it
    intensities: torch.Tensor
    blocked: torch.Tensor | None  # None with blocking off
    final_intensities: torch.Tensor  # with blocking, reflectivity and extinction


def line_target_intersections(
    ray_directions: torch.Tensor,
    ray_magnitude: float | torch.Tensor,
    aligned_surface_points: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    bitmap_resolution: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each heliostat's rays ``[M, r, P, 4]`` against its target area (global index
    ``[M]``, planar areas first): :func:`~geometry.line_plane_intersections` or
    :func:`~geometry.line_cylinder_intersections` as the tower holds only one
    kind; on a mixed tower both, selected per heliostat."""
    n_planar = tower.number_of_planar_target_areas
    n_cylindrical = tower.number_of_cylindrical_target_areas
    arguments = (ray_directions, ray_magnitude, aligned_surface_points, tower)
    if n_cylindrical == 0:
        return geometry.line_plane_intersections(
            *arguments, target_area_indices, bitmap_resolution
        )
    if n_planar == 0:
        return geometry.line_cylinder_intersections(
            *arguments, target_area_indices - n_planar, bitmap_resolution
        )
    plane = geometry.line_plane_intersections(
        *arguments, torch.clamp(target_area_indices, 0, n_planar - 1), bitmap_resolution
    )
    cylinder = geometry.line_cylinder_intersections(
        *arguments,
        torch.clamp(target_area_indices - n_planar, 0, n_cylindrical - 1),
        bitmap_resolution,
    )
    planar = (target_area_indices < n_planar)[:, None, None]
    return tuple(torch.where(planar, p, c) for p, c in zip(plane, cylinder))


def ray_splat_inputs(
    tower: SolarTower,
    preferred_directions: torch.Tensor,
    aligned_surface_points: torch.Tensor,
    target_area_indices: torch.Tensor,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    ray_magnitude: float | torch.Tensor,
    config: RenderConfig,
    blocking_primitives: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    ray_primitive_indices: torch.Tensor | None = None,
) -> ChunkRays:
    """Scatter, intersect and block one chunk of rays: the splat's inputs.

    Parameters
    ----------
    preferred_directions : torch.Tensor
        Mirror reflections of the incident direction, ``[M, P, 4]``.
    distortions_u, distortions_e : torch.Tensor
        The chunk's sun scatter angles, ``[M, r, P]``.
    blocking_primitives, ray_primitive_indices :
        As for :func:`trace_rays`; read only with ``config.blocking_active``.
    """
    ray_directions = apply_distortion_rotation(
        e=distortions_e, u=distortions_u, directions=preferred_directions[:, None, :, :]
    )  # [M, r, P, 4]
    bitmap_e, bitmap_u, distances, intensities = line_target_intersections(
        ray_directions,
        ray_magnitude,
        aligned_surface_points,
        tower,
        target_area_indices,
        config.bitmap_resolution,
    )
    blocked = None
    final_intensities = intensities
    if config.blocking_active:
        corners, spans, normals = blocking_primitives
        blocked = soft_ray_blocking_mask(
            ray_origins=aligned_surface_points,
            ray_directions=ray_directions,
            blocking_primitives_corners=corners,
            blocking_primitives_spans=spans,
            blocking_primitives_normals=normals,
            intersection_distances_target=distances,
            ray_primitive_indices=ray_primitive_indices,
            primitive_chunk=config.primitive_chunk,
            max_candidates=config.blocking_candidates,
        )
        final_intensities = intensities * (1.0 - blocked)
    final_intensities = (
        final_intensities * (1.0 - config.ray_extinction_factor) * config.mirror_reflectivity
    )
    return ChunkRays(
        ray_directions, bitmap_e, bitmap_u, distances, intensities, blocked, final_intensities
    )


def blocked_splat_inputs(
    tower: SolarTower,
    preferred_directions: torch.Tensor,
    aligned_surface_points: torch.Tensor,
    target_area_indices: torch.Tensor,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    ray_magnitude: float | torch.Tensor,
    config: RenderConfig,
    blocking_primitives: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    ray_primitive_indices: torch.Tensor | None,
) -> tuple[torch.Tensor, ...]:
    """Scatter, intersect and block one chunk of rays on the compacted route, on planar targets.

    The semantics of :func:`ray_splat_inputs` with ``soft_ray_blocking_mask``'s compacted
    route, through :mod:`artist_tpu_torch.kernels.blocked_rays`: the rays' directions and
    target distances for the sigma pair, each heliostat's corridor statistics without the
    rays' ``[M, r, P, 4]`` tensor, the candidates (``blocking.select_blocking_candidates``),
    sigma, and the intensities through ``1 - exp(-alpha sigma)``. Returns ``bitmap_e``,
    ``bitmap_u``, the final intensities ``[M, r, P]``, and the rays on target, intercepted and
    unblocked (``blocked < 1e-3``) ``[M]``.
    """
    from artist_tpu_torch.kernels import blocked_rays

    num, rays, points = distortions_u.shape
    preferred = preferred_directions.contiguous()
    origins = aligned_surface_points.contiguous()
    directions, distances, e, u, intensities, on_target, partials = blocked_rays.blocked_trace(
        preferred, origins, distortions_u, distortions_e, tower, target_area_indices, ray_magnitude,
        config.bitmap_resolution,
    )
    corners, spans, normals = blocking_primitives
    with span("artist.blocking.mask"):
        with span("artist.blocking.primitives"):
            table = blocking.primitive_table(corners, spans, normals, blocking.EPSILON).to(origins.dtype)
        with span("artist.blocking.candidates"):
            statistics = blocked_rays.corridor_statistics(
                preferred, aligned_surface_points, distortions_u, distortions_e, directions, distances, partials
            )
            indices, valid = blocking.select_blocking_candidates(
                aligned_surface_points, None, corners, ray_primitive_indices, None, config.blocking_candidates,
                statistics=statistics,
            )
            columns, keep = blocking.candidate_columns(table, indices, valid, num * rays * points)
        sigma = blocking_sigma(
            origins, directions, distances, columns, keep, blocking.SOFTNESS, blocking.RAY_ORIGIN_OFFSET,
            blocking.EPSILON,
        )
    w, intercepted, unblocked = blocked_rays.blocked_epilogue(
        intensities, sigma, blocking.ALPHA, config.ray_extinction_factor, config.mirror_reflectivity
    )
    return e, u, w, on_target, intercepted, unblocked


_SAVED_BLOCKING_OPS = (
    torch.ops.artist_tpu_torch.blocking_sigma.default,
    torch.ops.artist_tpu_torch.blocking_sigma_flat.default,
    torch.ops.artist_tpu_torch.blocking_cull.default,
)


def _save_blocking_sigma(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy: keep the sigma operators' and the cull's outputs,
    recompute the rest."""
    if op in _SAVED_BLOCKING_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def point_permutation(config: RenderConfig, device) -> torch.Tensor | None:
    """The block-window route's order of the surface points (``point_tile_order``
    of ``config.splat_point_layout``, int32), or None without a layout."""
    if config.splat_point_layout is None:
        return None
    points_u, points_v, facets = config.splat_point_layout
    order = point_tile_order(points_u, points_v, facets, config.splat_point_tile)
    return torch.tensor(order, dtype=torch.int32, device=device)


def trace_rays(
    tower: SolarTower,
    aligned_surface_points: torch.Tensor,
    aligned_surface_normals: torch.Tensor,
    incident_ray_directions: torch.Tensor,
    target_area_indices: torch.Tensor,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    ray_magnitude: float | torch.Tensor = 1.0,
    blocking_primitives: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    ray_primitive_indices: torch.Tensor | None = None,
    config: RenderConfig = RenderConfig(),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trace heliostat rays onto the tower's target areas and splat flux bitmaps.

    Parameters
    ----------
    tower : SolarTower
        Target-area tensors.
    aligned_surface_points, aligned_surface_normals : torch.Tensor
        World-frame aligned surfaces ``[M, P, 4]``.
    incident_ray_directions : torch.Tensor
        ``[M, 4]``.
    target_area_indices : torch.Tensor
        Global target index per active heliostat ``[M]``.
    distortions_u, distortions_e : torch.Tensor
        Sun scatter angles ``[M, R, P]``.
    ray_magnitude : float | torch.Tensor
        Per-ray power (DNI-derived) or 1.0.
    blocking_primitives : tuple | None
        (corners ``[B, 4, 4]``, spans ``[B, 2, 4]``, normals ``[B, 4]``) of
        the potential blockers; required when ``config.blocking_active``.
    ray_primitive_indices : torch.Tensor | None
        Global primitive index owned by each active heliostat ``[M]`` (a
        heliostat never blocks itself).
    config : RenderConfig
        Options.

    Returns
    -------
    tuple of torch.Tensor
        Flux bitmaps ``[M, height_u, width_e]``, intercept factor ``[M]``,
        on-target factor ``[M]``, (non-)blocking factor ``[M]``: the share of
        rays with ``blocked < 1e-3``.
    """
    if config.blocking_active and blocking_primitives is None:
        raise ValueError("blocking_active needs blocking_primitives")
    num_active, num_rays, num_points = distortions_u.shape

    preferred = geometry.reflect(
        incident_ray_directions[:, None, :], aligned_surface_normals
    )  # [M, P, 4]
    permutation = point_permutation(config, preferred.device)

    # Planar targets without blocking: the chain from angles to the splat's inputs is
    # one kernel pair, which keeps no per-ray tensor. Blocking reads the rays'
    # directions and distances, and a cylinder its own intersection: the PyTorch chain.
    fused = not config.blocking_active and tower.number_of_cylindrical_target_areas == 0
    # The compacted blocking route on planar targets takes its own kernels around the sigma
    # pair; the flat route and cylinders keep the PyTorch chain.
    compacted = (
        config.blocking_active
        and config.blocking_candidates is not None
        and tower.number_of_cylindrical_target_areas == 0
    )

    def trace_chunk(du: torch.Tensor, de: torch.Tensor):
        blocked = None
        if fused:
            e, u, w, on_target_count, intercept_count = ray_chunk(
                preferred, aligned_surface_points, du, de, tower, target_area_indices, ray_magnitude,
                config.bitmap_resolution, config.ray_extinction_factor, config.mirror_reflectivity,
            )
        elif compacted:
            e, u, w, on_target_count, intercept_count, unblocked_count = blocked_splat_inputs(
                tower, preferred, aligned_surface_points, target_area_indices, du, de, ray_magnitude, config,
                blocking_primitives, ray_primitive_indices,
            )
        else:
            rays = ray_splat_inputs(
                tower,
                preferred,
                aligned_surface_points,
                target_area_indices,
                du,
                de,
                ray_magnitude,
                config,
                blocking_primitives,
                ray_primitive_indices,
            )
            e, u, w, blocked = rays.bitmap_e, rays.bitmap_u, rays.final_intensities, rays.blocked
            on_target_count = torch.sum(rays.intensities > 0, dim=(1, 2))
            intercept_count = torch.sum(w > 0, dim=(1, 2))
        if config.splat_block_window is not None:
            partial_flux = splat_dynamic_window(
                e.contiguous(),
                u.contiguous(),
                w.contiguous(),
                config.bitmap_resolution,
                config.splat_block_window,
                point_order=permutation,
            )
        else:
            partial_flux = bilinear_splat(
                e,
                u,
                w,
                config.bitmap_resolution,
                flip_up_down=False,
                window=config.splat_window,
            )
        if compacted:
            return partial_flux, on_target_count, intercept_count, unblocked_count
        if blocked is None:
            unblocked_count = torch.full_like(on_target_count, du.shape[1] * num_points)
        else:
            unblocked_count = torch.sum(blocked < 1e-3, dim=(1, 2))
        return partial_flux, on_target_count, intercept_count, unblocked_count

    chunk = config.ray_chunk
    if chunk is None or chunk >= num_rays:
        flux, on_target_count, intercept_count, unblocked_count = trace_chunk(
            distortions_u, distortions_e
        )
    else:
        if num_rays % chunk != 0:
            raise ValueError(
                f"ray_chunk ({chunk}) must divide the number of rays ({num_rays})."
            )
        context_fn = (
            functools.partial(create_selective_checkpoint_contexts, _save_blocking_sigma)
            if config.blocking_active
            else noop_context_fn
        )
        flux = on_target_count = intercept_count = unblocked_count = 0
        for start in range(0, num_rays, chunk):
            du = distortions_u[:, start : start + chunk]
            de = distortions_e[:, start : start + chunk]
            if config.remat_chunks:
                partial = checkpoint(
                    trace_chunk, du, de, use_reentrant=False, preserve_rng_state=False,
                    context_fn=context_fn,
                )
            else:
                partial = trace_chunk(du, de)
            flux = flux + partial[0]
            on_target_count = on_target_count + partial[1]
            intercept_count = intercept_count + partial[2]
            unblocked_count = unblocked_count + partial[3]

    # Bitmap origin is bottom-left: flip rows once at the end.
    flux = torch.flip(flux, dims=(1,))

    rays_per_heliostat = num_rays * num_points
    intercept_factor = intercept_count / rays_per_heliostat
    on_target_factor = on_target_count / rays_per_heliostat
    blocking_factor = unblocked_count / rays_per_heliostat
    return flux, intercept_factor, on_target_factor, blocking_factor


def get_bitmaps_per_target(
    bitmaps_per_heliostat: torch.Tensor,
    target_area_indices: torch.Tensor,
    number_of_target_areas: int,
) -> torch.Tensor:
    """Sum per-heliostat bitmaps ``[M, H, W]`` into per-target bitmaps ``[T, H, W]``."""
    out = torch.zeros(
        (number_of_target_areas,) + tuple(bitmaps_per_heliostat.shape[1:]),
        dtype=bitmaps_per_heliostat.dtype,
        device=bitmaps_per_heliostat.device,
    )
    return out.index_add(0, target_area_indices, bitmaps_per_heliostat)


def compute_ray_magnitude(
    dni: float,
    canting: torch.Tensor,
    number_of_surface_points: int,
    number_of_rays: int,
) -> float:
    """Per-ray power from direct normal irradiance and heliostat area.

    Heliostat dimensions come from the canting-vector norms of the first
    heliostat (facet half-extents x 4 + 2 cm gap).
    """
    canting_norm = torch.linalg.vector_norm(canting[0], dim=-1)[0][:2]
    dimensions = canting_norm * 4 + 0.02
    area = float(dimensions[0] * dimensions[1])
    return dni * area / (number_of_surface_points * number_of_rays)

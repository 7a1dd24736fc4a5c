"""Heliostat-on-heliostat blocking: the soft differentiable mask over the field's primitives.

Counterpart of ``artist_tpu/raytracing/blocking.py`` on both routes of its
Pallas kernels. Each heliostat is reduced to a rectangle (a primitive); the
pair kernels of :mod:`artist_tpu_torch.kernels.blocking` sum each ray's soft
occlusion sigma over primitives, and the mask is ``1 - exp(-alpha sigma)``.

- **Candidate-compacted** (``max_candidates`` set and target distances given,
  ``blocking.py:449-487`` and
  ``blocking_pallas.py:soft_ray_blocking_mask_pallas_compact``): a
  conservative corridor test picks each ray-owning heliostat's K most
  plausible blockers (stop-gradient), and the sum runs over those K only,
  with the reference cull's "blockers beyond the target hit do not block" as
  a per-ray hard gate.
- **Flat** (``max_candidates=None``, or no target distances;
  ``blocking.py:488-503`` and ``blocking_pallas.py:soft_ray_blocking_mask_pallas``):
  the sum runs over every primitive of the field that the AABB cull keeps. A
  primitive is kept when any ray of another heliostat enters its AABB before
  its target hit, the reference LBVH filter's semantics; without target
  distances every primitive is kept. This is also what the JAX package
  computes by default on the CPU (its dense XLA route), to within fp32
  rounding.

On every device these are the Pallas routes' semantics. Rays are not padded:
the CUDA kernels mask their ragged block edges themselves.
``primitive_chunk`` is accepted and changes nothing: it bounds the JAX XLA
route's ``[M, R, P, chunk]`` temporaries, which the kernels never hold (the
JAX Pallas routes ignore it too). ``cull_method="lbvh"`` finds the flat
route's keep flags by per-ray traversal of a linear bounding volume hierarchy
(:mod:`artist_tpu_torch.raytracing.lbvh`) instead of the dense AABB cull; the
keep-set is the same, and so is the mask, bit for bit. As in the JAX package,
whose compacted route requires the dense cull, it always takes the flat route.

The corridor test reads each heliostat's reductions over its rays
(:func:`heliostat_statistics`: the origins' centre and radius, the mean direction, the least
cosine to it, the farthest target distance); :func:`select_blocking_candidates` takes them
computed elsewhere as well, which ``render.blocked_splat_inputs`` does with the kernels of
:mod:`artist_tpu_torch.kernels.blocked_rays`, without the rays' ``[M, R, P, 4]`` tensor, and
:func:`candidate_columns` gathers the kept candidates' columns for the sigma pair on both.

Spans (:func:`~artist_tpu_torch.util.logging_utils.span`): ``artist.blocking.mask``
around :func:`soft_ray_blocking_mask`, ``artist.blocking.primitives`` around the
corners picked by index and the primitives' table, ``artist.blocking.candidates``
around the candidate test (the flat route's cull); the sigma operators open their
own (``artist.kernels.sigma_*``).

:data:`STATISTICS` keeps the compacted route's newest forwards, a checkpoint's
recompute included: each one's rays and its kept-slot mask ``[M, K]`` (bool, on the
tensors' device) as computed, neither read nor reduced, so that counting adds no
launch and no wait for the device. :func:`blocking_statistics` reads them when asked.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from artist_tpu_torch.geometry.transforms import _normalize
from artist_tpu_torch.kernels.blocking import NUM_COLUMNS, blocking_cull, blocking_sigma, blocking_sigma_flat
from artist_tpu_torch.raytracing.lbvh import lbvh_keep
from artist_tpu_torch.util.logging_utils import span

# Candidate lists are padded to a multiple of the TPU path's primitive tile,
# so that both packages see the same K.
CANDIDATE_TILE = 16
# The soft mask's defaults: the gates' softness, the in-front offset of a ray's
# origin (m), the smallest |d . n| and Gram determinant, and the opacity alpha
# of 1 - exp(-alpha sigma).
SOFTNESS = 1000.0
RAY_ORIGIN_OFFSET = 0.05
EPSILON = 1e-12
ALPHA = 100.0
# The compacted route's newest 256 forwards: (rays, kept-slot mask).
STATISTICS: collections.deque[tuple[int, torch.Tensor]] = collections.deque(maxlen=256)


def blocking_statistics() -> dict[str, int]:
    """The forwards :data:`STATISTICS` holds, summed: ``forwards``, ``rays`` tested,
    ``heliostats`` that cast them, ``candidate_slots`` (K a heliostat), ``kept_slots`` (slots
    that the corridor test kept) and ``heliostats_kept`` (heliostats with a kept slot). Reads
    the masks from the device."""
    out = dict(forwards=len(STATISTICS), rays=0, heliostats=0, candidate_slots=0, kept_slots=0, heliostats_kept=0)
    for rays, kept in STATISTICS:
        out["rays"] += rays
        out["heliostats"] += kept.shape[0]
        out["candidate_slots"] += kept.numel()
        out["kept_slots"] += int(kept.sum())
        out["heliostats_kept"] += int(kept.any(dim=1).sum())
    return out


def _rectangle(corners: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Corners ``[H, 4, 4]`` -> (corners, spans ``[H, 2, 4]``, unit normals ``[H, 4]``)."""
    spans = torch.stack([corners[:, 1] - corners[:, 0], corners[:, 3] - corners[:, 0]], dim=1)
    normals3 = _normalize(torch.linalg.cross(spans[:, 0, :3], spans[:, 1, :3]))
    normals = torch.cat([normals3, torch.zeros_like(normals3[:, :1])], dim=-1)
    return corners, spans, normals


def create_blocking_primitives_rectangle(
    surface_points: torch.Tensor, active_surface_points: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduce each heliostat to a rectangle by nearest-corner search.

    Corner indices come from the unaligned (flat) points ``[H, P, 4]``,
    positions from the aligned points ``[H, P, 4]``. Corner order is
    counter-clockwise from the lower left: ``(min_e, min_n)``,
    ``(min_e, max_n)``, ``(max_e, max_n)``, ``(max_e, min_n)``.

    Returns
    -------
    tuple of torch.Tensor
        corners ``[H, 4, 4]``, spans ``[H, 2, 4]`` (u = c1 - c0, v = c3 - c0),
        unit normals ``[H, 4]``.
    """
    e, n = surface_points[:, :, 0], surface_points[:, :, 1]
    min_e, max_e = e.min(dim=1).values, e.max(dim=1).values
    min_n, max_n = n.min(dim=1).values, n.max(dim=1).values
    expected = torch.stack(
        [
            torch.stack([min_e, min_n], dim=1),
            torch.stack([min_e, max_n], dim=1),
            torch.stack([max_e, max_n], dim=1),
            torch.stack([max_e, min_n], dim=1),
        ],
        dim=1,
    )  # [H, 4, 2]
    distances = torch.linalg.vector_norm(
        surface_points[:, :, None, :2] - expected[:, None, :, :], dim=-1
    )  # [H, P, 4]
    corner_indices = torch.argmin(distances, dim=1)  # [H, 4]
    corners = torch.gather(
        active_surface_points, 1, corner_indices[..., None].expand(-1, -1, 4)
    )
    return _rectangle(corners)


def create_blocking_primitives_rectangles_by_index(
    surface_points: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduce each heliostat to its 4 corners picked by fixed index.

    Assumes the canonical 4-facet 2 x 2 layout with row-major per-facet point
    grids. ``surface_points`` are world-frame points ``[H, P, 4]``.

    Returns
    -------
    tuple of torch.Tensor
        corners ``[H, 4, 4]`` (lower-left, upper-left, upper-right,
        lower-right), spans ``[H, 2, 4]`` (u = ul - ll, v = lr - ll), unit
        normals ``[H, 4]``.
    """
    count = surface_points.shape[1]
    side = int(math.sqrt(count / 4))
    with span("artist.blocking.primitives"):
        corners = torch.stack(
            [
                surface_points[:, count // 2],
                surface_points[:, side - 1],
                surface_points[:, count // 2 - 1],
                surface_points[:, count - side],
            ],
            dim=1,
        )
        return _rectangle(corners)


class HeliostatStatistics(NamedTuple):
    """What the corridor test reads of each heliostat's rays, each ``[M]`` or ``[M, 3]``."""

    center: torch.Tensor  # the mean of its ray origins (surface points)
    radius: torch.Tensor  # the largest distance of an origin from the centre
    mean_direction: torch.Tensor  # its rays' mean direction, normalised
    least_cosine: torch.Tensor  # the least cosine of a ray to the mean direction (not clamped)
    farthest: torch.Tensor  # the largest target distance of a ray


@torch.no_grad()
def heliostat_statistics(
    ray_origins: torch.Tensor, ray_directions: torch.Tensor, intersection_distances_target: torch.Tensor
) -> HeliostatStatistics:
    """The corridor test's reductions over each heliostat's rays: origins ``[M, P, 4]``,
    directions ``[M, R, P, 4]``, target distances ``[M, R, P]`` (stop-gradient)."""
    origins = ray_origins[..., :3].detach()  # [M, P, 3]
    directions = ray_directions[..., :3].detach()  # [M, R, P, 3]
    center_m = origins.mean(dim=1)  # [M, 3]
    radius_m = torch.sqrt(((origins - center_m[:, None]) ** 2).sum(dim=-1).max(dim=1).values)
    mean_direction = _normalize(directions.mean(dim=(1, 2)), eps=1e-9)
    cos_dev = torch.einsum("mrpk,mk->mrp", directions, mean_direction).amin(dim=(1, 2))
    t_max = intersection_distances_target.detach().amax(dim=(1, 2))  # [M]
    return HeliostatStatistics(center_m, radius_m, mean_direction, cos_dev, t_max)


@torch.no_grad()
def select_blocking_candidates(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor | None,
    blocking_primitives_corners: torch.Tensor,
    ray_primitive_indices: torch.Tensor | None,
    intersection_distances_target: torch.Tensor | None,
    max_candidates: int,
    margin: float = 0.25,
    statistics: HeliostatStatistics | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Conservative per-heliostat top-K candidate blocker selection (stop-gradient).

    Heliostat m's rays start within its bounding sphere (radius ``r_m``) and
    deviate from their mean direction by at most ``tan_dev_m``; a primitive
    whose bounding sphere lies outside the corridor
    ``r_m + r_b + t tan_dev_m + margin`` cannot block them. The primitives
    most inside the corridor rank first; a heliostat's own primitive never
    passes. ``statistics`` gives each heliostat's reductions over its rays as
    :func:`heliostat_statistics` computes them; given, the rays (``ray_origins``,
    ``ray_directions``, ``intersection_distances_target``) are not read.

    Returns
    -------
    tuple of torch.Tensor
        Candidate primitive indices ``[M, K]`` (int64) and validity
        ``[M, K]`` (bool), K = ``max_candidates`` clamped to B.
    """
    if statistics is None:
        statistics = heliostat_statistics(ray_origins, ray_directions, intersection_distances_target)
    center_m, radius_m, mean_direction, cos_dev, t_max = statistics
    corners = blocking_primitives_corners[:, :, :3].detach()
    number_of_primitives = corners.shape[0]
    k = min(max_candidates, number_of_primitives)

    cos_dev = torch.clamp(cos_dev, 0.05, 1.0)
    tan_dev = torch.sqrt(torch.clamp(1.0 - cos_dev**2, min=0.0)) / cos_dev  # [M]

    center_b = corners.mean(dim=1)  # [B, 3]
    radius_b = torch.sqrt(((corners - center_b[:, None]) ** 2).sum(dim=-1).max(dim=1).values)

    relative = center_b[None] - center_m[:, None]  # [M, B, 3]
    t_b = torch.einsum("mbk,mk->mb", relative, mean_direction)
    lateral_sq = (relative * relative).sum(dim=-1) - t_b * t_b
    reach = radius_m[:, None] + radius_b[None] + tan_dev[:, None] * torch.clamp(t_b, min=0.0) + margin
    passes = (
        (t_b > -radius_b[None])
        & (t_b - radius_b[None] < t_max[:, None])
        & (lateral_sq < reach * reach)
    )
    if ray_primitive_indices is not None:
        own = torch.arange(number_of_primitives, device=passes.device)[None, :]
        passes = passes & (ray_primitive_indices[:, None] != own)

    # Most inside the corridor first; failed slots rank last.
    score = torch.where(passes, lateral_sq - reach * reach, torch.full_like(lateral_sq, math.inf))
    candidate_indices = torch.topk(-score, k, dim=1).indices
    candidate_valid = torch.gather(passes, 1, candidate_indices)
    return candidate_indices, candidate_valid


def candidate_columns(
    table: torch.Tensor, indices: torch.Tensor, valid: torch.Tensor, rays: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sigma pair's ``columns [M, K', 16]`` and ``keep [M, K']`` (in the table's dtype) of
    the candidates ``indices`` / ``valid [M, K]`` that the corridor test chose for ``rays``
    rays, K padded to a multiple of :data:`CANDIDATE_TILE`; records the forward in
    :data:`STATISTICS`."""
    num = indices.shape[0]
    STATISTICS.append((rays, valid))
    # Pad K to a multiple of the tile with keep = 0 slots.
    k_pad = -(-indices.shape[1] // CANDIDATE_TILE) * CANDIDATE_TILE
    indices = torch.nn.functional.pad(indices, (0, k_pad - indices.shape[1]))
    valid = torch.nn.functional.pad(valid, (0, k_pad - valid.shape[1]))
    # One gather for all columns; its backward scatter-adds the candidates'
    # cotangents onto the primitives.
    columns = table.index_select(0, indices.reshape(-1)).reshape(num, k_pad, NUM_COLUMNS)
    return columns, valid.to(table.dtype)


def primitive_table(
    corners: torch.Tensor, spans: torch.Tensor, normals: torch.Tensor, epsilon: float = 1e-12
) -> torch.Tensor:
    """The 16 pre-reduced columns of each primitive, ``[B, 16]`` (differentiable).

    nx ny nz, ux uy uz, vx vy vz, c0.n, c0.u, c0.v, u.u, v.v, u.v and the
    reciprocal of the Gram determinant (its magnitude kept >= ``epsilon``).
    """
    corner_0 = corners[:, 0, :3]
    span_u, span_v = spans[:, 0, :3], spans[:, 1, :3]
    normals3 = normals[:, :3]
    span_u_sq = (span_u * span_u).sum(dim=-1)
    span_v_sq = (span_v * span_v).sum(dim=-1)
    span_uv = (span_u * span_v).sum(dim=-1)
    det = span_u_sq * span_v_sq - span_uv * span_uv
    det_safe = torch.where(
        torch.abs(det) < epsilon,
        torch.where(det >= 0, epsilon, -epsilon).to(det.dtype),
        det,
    )
    table = torch.stack(
        [
            *normals3.unbind(-1), *span_u.unbind(-1), *span_v.unbind(-1),
            (corner_0 * normals3).sum(dim=-1),
            (corner_0 * span_u).sum(dim=-1),
            (corner_0 * span_v).sum(dim=-1),
            span_u_sq, span_v_sq, span_uv, 1.0 / det_safe,
        ],
        dim=1,
    )
    return table


@torch.no_grad()
def cull_primitives(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    blocking_primitives_corners: torch.Tensor,
    ray_primitive_indices: torch.Tensor | None,
    intersection_distances_target: torch.Tensor,
) -> torch.Tensor:
    """The flat route's participation flags ``keep [B]`` (1.0 or 0.0; stop-gradient).

    Primitive ``b`` is kept when a ray not owned by ``b`` enters its
    axis-aligned bounding box before its target hit. Rays ``[M, R, P, 4]``
    (origins ``[M, P, 4]``), target distances ``[M, R, P]``; each heliostat's
    own primitive from ``ray_primitive_indices [M]`` (None: none).
    """
    num, rays, points = ray_directions.shape[:3]
    dtype = ray_origins.dtype
    corners = blocking_primitives_corners[:, :, :3].to(dtype)
    aabb = torch.cat([corners.amin(dim=1), corners.amax(dim=1)], dim=1).contiguous()
    if ray_primitive_indices is None:
        own = torch.full((num,), -1, dtype=torch.int64, device=ray_origins.device)
    else:
        own = ray_primitive_indices.to(torch.int64).contiguous()
    return blocking_cull(
        ray_origins.contiguous(),
        ray_directions.reshape(num, rays * points, 4).contiguous(),
        intersection_distances_target.reshape(num, rays * points).to(dtype).contiguous(),
        own,
        aabb,
    )


def soft_ray_blocking_mask(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    blocking_primitives_corners: torch.Tensor,
    blocking_primitives_spans: torch.Tensor,
    blocking_primitives_normals: torch.Tensor,
    intersection_distances_target: torch.Tensor | None = None,
    ray_primitive_indices: torch.Tensor | None = None,
    epsilon: float = EPSILON,
    softness: float = SOFTNESS,
    alpha: float = ALPHA,
    ray_origin_offset: float = RAY_ORIGIN_OFFSET,
    cull_method: str = "dense",
    primitive_chunk: int | None = None,
    method: str = "auto",
    max_candidates: int | None = None,
) -> torch.Tensor:
    """Soft differentiable blocking mask with Beer-Lambert accumulation.

    Parameters
    ----------
    ray_origins : torch.Tensor
        ``[M, P, 4]``.
    ray_directions : torch.Tensor
        ``[M, R, P, 4]``.
    blocking_primitives_* : torch.Tensor
        ``[B, 4, 4]`` corners, ``[B, 2, 4]`` spans, ``[B, 4]`` normals.
    intersection_distances_target : torch.Tensor | None
        Per-ray distance to the target hit ``[M, R, P]`` (no gradient): the
        compacted route's per-ray behind-target gate, the flat route's cull.
        None: the flat route over every primitive, without a cull.
    ray_primitive_indices : torch.Tensor | None
        Global primitive index owned by each ray-emitting heliostat ``[M]``.
    cull_method : str
        ``"dense"`` (the default): the compacted route with ``max_candidates``,
        else the flat route with the AABB cull. ``"lbvh"``: the flat route,
        whatever ``max_candidates`` says, its keep flags from the LBVH
        traversal (the same flags).
    primitive_chunk : int | None
        Accepted for the JAX signature's sake; changes nothing here.
    method : str
        The JAX package's choice of TPU formulation. Accepted and ignored, as
        ``RenderConfig.blocking_method`` is.
    max_candidates : int | None
        Candidate blockers per heliostat (K) of the compacted route; None
        selects the flat route (so does ``cull_method="lbvh"``).

    Returns
    -------
    torch.Tensor
        blocked in [0, 1], ``[M, R, P]``.
    """
    if cull_method not in ("dense", "lbvh"):
        raise ValueError(f"cull_method must be 'dense' or 'lbvh', got {cull_method!r}")
    with span("artist.blocking.mask"):
        num, rays, points = ray_directions.shape[:3]
        directions = ray_directions.reshape(num, rays * points, 4).contiguous()
        with span("artist.blocking.primitives"):
            table = primitive_table(
                blocking_primitives_corners, blocking_primitives_spans, blocking_primitives_normals, epsilon
            ).to(ray_origins.dtype)
        parameters = (float(softness), float(ray_origin_offset), float(epsilon))
        if cull_method == "dense" and max_candidates is not None and intersection_distances_target is not None:
            with span("artist.blocking.candidates"):
                indices, valid = select_blocking_candidates(
                    ray_origins, ray_directions, blocking_primitives_corners, ray_primitive_indices,
                    intersection_distances_target, max_candidates,
                )
                columns, keep = candidate_columns(table, indices, valid, num * rays * points)
            sigma = blocking_sigma(
                ray_origins.contiguous(),
                directions,
                intersection_distances_target.detach().reshape(num, rays * points).contiguous(),
                columns,
                keep,
                *parameters,
            )
        else:
            with span("artist.blocking.candidates"):
                if intersection_distances_target is None:
                    keep = torch.ones(table.shape[0], dtype=table.dtype, device=table.device)
                else:
                    cull = lbvh_keep if cull_method == "lbvh" else cull_primitives
                    keep = cull(
                        ray_origins, ray_directions, blocking_primitives_corners, ray_primitive_indices,
                        intersection_distances_target,
                    )
            sigma = blocking_sigma_flat(ray_origins.contiguous(), directions, table.contiguous(), keep, *parameters)
        return 1.0 - torch.exp(-alpha * sigma.reshape(num, rays, points))

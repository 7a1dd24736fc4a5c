"""Heliostat-on-heliostat blocking in plain PyTorch: rectangles, the candidate corridor, the soft occlusion.

ARTIST's soft blocking on its candidate-compacted route, as published:

- each heliostat stands for the rectangle of its aligned surface's four outer
  corners: the lower-left corner of its lower-left facet (the rectangle's origin),
  the upper-left one of its upper-left facet, the upper-right one of its upper-right
  facet and the lower-right one of its lower-right facet; its first side runs from
  the origin to the upper-left corner, its second to the lower-right one, and its
  normal is their cross product, made unit;
- a conservative corridor picks each heliostat's candidate blockers: its rays
  start within its bounding sphere and deviate from their mean direction by at
  most the widest ray's angle, so a rectangle whose bounding sphere lies outside
  the cone around that mean direction (widened by both radii and a margin), behind
  the heliostat or beyond its farthest target hit cannot block it; of the rest,
  the K most inside the corridor are its candidates, and a heliostat is never its
  own;
- a ray is occluded by a candidate softly: where it meets the rectangle's plane,
  the product of logistic gates of softness ``SOFTNESS`` that its two local
  coordinates lie in (0, 1) and that the meeting lies ``RAY_ORIGIN_OFFSET`` beyond
  its origin, and nothing where the meeting lies beyond its target hit; a ray's
  occlusions sum to sigma over its heliostat's candidates, and it is blocked by
  ``1 - exp(-ALPHA sigma)``.
"""

from __future__ import annotations

import math

import torch

SOFTNESS = 1000.0
ALPHA = 100.0
RAY_ORIGIN_OFFSET = 0.05
EPSILON = 1e-12  # the least magnitude of a denominator
MARGIN = 0.25  # m, added to the corridor's reach
FACETS = (("upper", "left"), ("upper", "right"), ("lower", "left"), ("lower", "right"))


def corner_indices(points_e: int, points_n: int) -> list[int]:
    """The surface points of the rectangle's four corners (origin, upper-left, upper-right,
    lower-right) in a surface of four facets in :data:`FACETS` order, each a grid of
    ``points_e x points_n`` points with e slowest."""
    per_facet = points_e * points_n

    def point(facet, e, n):
        return FACETS.index(facet) * per_facet + e * points_n + n

    last_e, last_n = points_e - 1, points_n - 1
    return [point(("lower", "left"), 0, 0), point(("upper", "left"), 0, last_n),
            point(("upper", "right"), last_e, last_n), point(("lower", "right"), last_e, 0)]


def rectangles(corners: torch.Tensor) -> dict[str, torch.Tensor]:
    """The rectangles of corners ``[B, 4, 3]`` (origin, upper-left, upper-right, lower-right):
    ``origin``, sides ``u`` and ``v`` and unit ``normal``, each ``[B, 3]``."""
    origin = corners[:, 0]
    u = corners[:, 1] - origin
    v = corners[:, 3] - origin
    normal = torch.linalg.cross(u, v, dim=-1)
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=EPSILON)
    return dict(corners=corners, origin=origin, u=u, v=v, normal=normal)


@torch.no_grad()
def candidates(origins: torch.Tensor, directions: torch.Tensor, target_distances: torch.Tensor,
               corners: torch.Tensor, own: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each heliostat's ``count`` candidate rectangles, most inside its corridor first, and
    which of them pass the corridor test: (indices, kept), each ``[M, count]``.

    ``origins`` ``[M, P, 3]`` (its surface points), ``directions`` ``[M, R, P, 3]`` (unit),
    ``target_distances`` ``[M, R, P]`` (0 for a ray that misses the target),
    ``corners`` ``[B, 4, 3]`` of every rectangle of the field, ``own`` ``[M]`` its own."""
    center = origins.mean(dim=1)
    radius = torch.sqrt(((origins - center[:, None]) ** 2).sum(dim=-1).amax(dim=1))
    mean = directions.mean(dim=(1, 2))
    mean = mean / torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), min=1e-9)
    widest = torch.clamp((directions * mean[:, None, None]).sum(dim=-1).amin(dim=(1, 2)), 0.05, 1.0)
    spread = torch.sqrt(torch.clamp(1.0 - widest**2, min=0.0)) / widest  # tangent of the widest angle
    farthest = target_distances.amax(dim=(1, 2))

    blocker_center = corners.mean(dim=1)
    blocker_radius = torch.sqrt(((corners - blocker_center[:, None]) ** 2).sum(dim=-1).amax(dim=1))
    offset = blocker_center[None] - center[:, None]  # [M, B, 3]
    along = (offset * mean[:, None]).sum(dim=-1)
    across = (offset * offset).sum(dim=-1) - along**2
    reach = radius[:, None] + blocker_radius[None] + spread[:, None] * torch.clamp(along, min=0.0) + MARGIN
    passes = ((along > -blocker_radius[None]) & (along - blocker_radius[None] < farthest[:, None])
              & (across < reach**2))
    passes &= own[:, None] != torch.arange(corners.shape[0], device=corners.device)[None]
    depth = torch.where(passes, across - reach**2, torch.full_like(across, math.inf))
    indices = torch.topk(depth, min(count, corners.shape[0]), dim=1, largest=False).indices
    return indices, torch.gather(passes, 1, indices)


def occlusion(origins: torch.Tensor, directions: torch.Tensor, target_distances: torch.Tensor,
              rectangle: dict[str, torch.Tensor]) -> torch.Tensor:
    """One rectangle a heliostat (``rectangle``'s entries ``[M, 3]``) against its rays: the soft
    occlusion ``[M, R, P]`` of rays from ``origins`` ``[M, 1, P, 3]`` along ``directions``
    ``[M, R, P, 3]``."""
    def dot(a, b):
        return (a * b).sum(dim=-1)

    def per_heliostat(x):
        return x[:, None, None]

    origin, u, v, normal = (rectangle[key][:, None, None] for key in ("origin", "u", "v", "normal"))
    facing = dot(directions, normal)
    facing = torch.where(facing.abs() >= EPSILON, facing, torch.where(facing >= 0, EPSILON, -EPSILON))
    distance = dot(origin - origins, normal) / facing
    meeting = origins + distance[..., None] * directions - origin
    uu, vv, uv = (per_heliostat(dot(rectangle[x], rectangle[y])) for x, y in (("u", "u"), ("v", "v"), ("u", "v")))
    determinant = uu * vv - uv**2
    determinant = torch.where(determinant.abs() >= EPSILON, determinant,
                              torch.where(determinant >= 0, EPSILON, -EPSILON))
    along_u, along_v = dot(meeting, u), dot(meeting, v)
    a = (along_u * vv - along_v * uv) / determinant
    b = (along_v * uu - along_u * uv) / determinant
    k = SOFTNESS
    gates = (torch.sigmoid(k * a) * torch.sigmoid(k * (1 - a)) * torch.sigmoid(k * b) * torch.sigmoid(k * (1 - b))
             * torch.sigmoid(k * (distance - RAY_ORIGIN_OFFSET)))
    return torch.where(distance <= target_distances, gates, torch.zeros_like(gates))


def kept_rectangles(field_rectangles: dict[str, torch.Tensor], indices: torch.Tensor, kept: torch.Tensor):
    """For each candidate slot that some heliostat keeps: (the heliostats ``[k]`` that keep it,
    their rectangles in it, each entry ``[k, 3]``)."""
    for slot in range(indices.shape[1]):
        rows = torch.nonzero(kept[:, slot]).flatten()
        if rows.numel():
            chosen = indices[rows, slot]
            yield rows, {key: field_rectangles[key][chosen] for key in ("origin", "u", "v", "normal")}


def blocked(origins: torch.Tensor, directions: torch.Tensor, target_distances: torch.Tensor,
            field_rectangles: dict[str, torch.Tensor], indices: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """``1 - exp(-ALPHA sigma)`` ``[M, R, P]``: sigma the sum of the rays' occlusions by their
    heliostat's kept candidates (``indices``, ``kept`` ``[M, K]``; rays as for :func:`occlusion`)."""
    sigma = torch.zeros_like(target_distances)
    for rows, rectangle in kept_rectangles(field_rectangles, indices, kept):
        sigma = sigma.index_add(0, rows, occlusion(origins[rows], directions[rows], target_distances[rows],
                                                   rectangle))
    return 1.0 - torch.exp(-ALPHA * sigma)


@torch.no_grad()
def pair_counts(origins: torch.Tensor, directions: torch.Tensor, target_distances: torch.Tensor,
                intensities: torch.Tensor, field_rectangles: dict[str, torch.Tensor], indices: torch.Tensor,
                kept: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per heliostat ``[M]``: its kept slots, its kept (ray, slot) pairs, and of those the pairs
    whose occlusion is exactly 0 (``zero``: the meeting beyond the target hit, or gates that
    underflow to 0) and those that are so or whose ray carries no power (``zero_or_dark``: a
    ray without power gets a zero cotangent)."""
    rays = directions.shape[1] * directions.shape[2]
    zero = torch.zeros(kept.shape[0], dtype=torch.int64, device=kept.device)
    out = dict(kept_slots=kept.sum(dim=1), kept_pairs=kept.sum(dim=1) * rays, zero=zero, zero_or_dark=zero.clone())
    for rows, rectangle in kept_rectangles(field_rectangles, indices, kept):
        nothing = occlusion(origins[rows], directions[rows], target_distances[rows], rectangle) == 0
        out["zero"].index_add_(0, rows, nothing.flatten(1).sum(dim=1))
        out["zero_or_dark"].index_add_(0, rows, (nothing | (intensities[rows] == 0)).flatten(1).sum(dim=1))
    return out

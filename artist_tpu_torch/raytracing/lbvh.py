"""Linear bounding volume hierarchy (Karras, HPG 2012) over the blocking primitives.

Counterpart of ``artist_tpu/raytracing/lbvh.py``: Morton codes, the
longest common prefix, the radix-tree build, the slab test and the LBVH
filter of the blocking primitives. The build is plain PyTorch, vectorized
over the B primitives (at most a few thousand); the traversal is the CUDA
kernel of :mod:`artist_tpu_torch.kernels.lbvh` (its plain version on the
CPU). Nothing here is differentiable: the filter's keep flags gate the flat
route's soft mask, as the reference's no-grad cull.

Two differences from the JAX package, both deliberate:

- **The split search** steps by ``ceil(l / 2), ceil(l / 4), ..., 1``, as
  Karras's algorithm does, with the guard ``split + t <= length``. The JAX
  package halves its step by floor (``t = (length + 1) // 2``, then
  ``t // 2``), which cannot reach every split: its tree's root then misses
  leaves (37 of 64 and 99 of 300 primitives on
  ``tests/raytracing/test_lbvh.py``'s random fields) and its filter keeps
  fewer primitives than the dense cull it is documented to equal.
- **Internal boxes** are the bounds of each node's range of Morton-sorted
  leaves, ``[min(i, j), max(i, j)]``, taken from a sparse table of running
  minima and maxima, instead of a bottom-up propagation in rounds; for a
  well-formed tree the two are the same boxes (minima and maxima are exact).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from artist_tpu_torch.kernels.lbvh import STACK_SIZE, lbvh_traverse

MORTON_BITS = 30


def expand_bits(integers: torch.Tensor) -> torch.Tensor:
    """Spread the lower 10 bits of each integer by two zero bits between bits (int32)."""
    expanded = integers.to(torch.int32) & 0x000003FF
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
        expanded = (expanded | (expanded << shift)) & mask
    return expanded


def morton_codes(coordinates: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """30-bit Morton codes of points ``[B, 3]`` (e, n, u), north first, then east, then up.

    The same fp32 expression as the JAX package's, ``(c - mins) * (1023 /
    (max(maxs - mins) + epsilon))``, cast to int32 by truncation, so the
    codes are bit-equal.
    """
    mins = coordinates.amin(dim=0)
    maxs = coordinates.amax(dim=0)
    # A true division: ``1023 / tensor`` would multiply by the tensor's reciprocal.
    scale = torch.tensor(float((1 << 10) - 1), dtype=coordinates.dtype, device=coordinates.device)
    scaled = ((coordinates - mins) * (scale / (torch.max(maxs - mins) + epsilon))).to(torch.int32)
    u = expand_bits(scaled[:, 2])
    e = expand_bits(scaled[:, 0]) << 1
    n = expand_bits(scaled[:, 1]) << 2
    return n | e | u


def _leading_zeros32(values: torch.Tensor) -> torch.Tensor:
    """Leading zeros of non-negative 32-bit values, 31 for 0, as the JAX package's
    shift-and-test loop counts them. ``frexp`` of the value as float64 (exact for
    every int32) gives its bit length in a few operations, not thirty."""
    _, bit_length = torch.frexp(values.to(torch.float64))
    return torch.where(values == 0, 31, 32 - bit_length).to(torch.int32)


def longest_common_prefix(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Common prefix, in bits of 30, of sorted Morton codes ``codes[i]`` and ``codes[j]`` (int32).

    An out-of-range ``j`` gives -1. Equal codes are told apart by their
    indices' common prefix (30 + its leading zeros), so the tree stays well
    formed with duplicate centroids.
    """
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    j_safe = j.clamp(0, n - 1)
    differing = codes[i] ^ codes[j_safe]
    lcp = (MORTON_BITS - 1) - (31 - _leading_zeros32(differing))
    tie_broken = MORTON_BITS + _leading_zeros32((i ^ j_safe).to(torch.int32))
    lcp = torch.where(differing == 0, tie_broken, lcp)
    return torch.where(valid, lcp, torch.full_like(lcp, -1))


class LBVH(NamedTuple):
    """Flat radix-tree arrays: the B - 1 internal nodes first (the root is node 0),
    then the B leaves in Morton order."""

    left: torch.Tensor  # [2B - 1] child index, -1 for a leaf (int64)
    right: torch.Tensor  # [2B - 1]
    aabb_min: torch.Tensor  # [2B - 1, 3]
    aabb_max: torch.Tensor  # [2B - 1, 3]
    is_leaf: torch.Tensor  # [2B - 1] bool
    primitive_index: torch.Tensor  # [2B - 1] the leaf's primitive, -1 for an internal node


def _range_bounds(values: torch.Tensor, low: torch.Tensor, high: torch.Tensor, reduce) -> torch.Tensor:
    """``reduce`` (torch.minimum or torch.maximum) of ``values [B, 3]`` over each row range
    ``[low, high]``, from a sparse table: two overlapping power-of-two windows a range."""
    count = values.shape[0]
    table = [values]
    while (1 << len(table)) <= count:
        half = 1 << (len(table) - 1)
        previous = table[-1]
        table.append(reduce(previous[:-half], previous[half:]))
    span = high - low + 1
    level = torch.floor(torch.log2(span.to(torch.float64))).long()
    padded = torch.stack([torch.cat([t, t[-1:].expand(count - t.shape[0], 3)]) for t in table])
    return reduce(padded[level, low], padded[level, high - (1 << level) + 1])


def build_linear_bounding_volume_hierarchies(blocking_primitives_corners: torch.Tensor) -> LBVH:
    """The LBVH over rectangle primitives ``[B, 4, 4]``, Karras's construction."""
    corners = blocking_primitives_corners[..., :3].detach()
    device = corners.device
    count = corners.shape[0]
    primitive_mins = corners.amin(dim=1)
    primitive_maxs = corners.amax(dim=1)
    long = dict(dtype=torch.long, device=device)
    if count == 0:
        empty = torch.empty((0,), **long)
        return LBVH(empty, empty, primitive_mins, primitive_maxs, torch.empty((0,), dtype=torch.bool,
                                                                               device=device), empty)
    if count == 1:
        minus_one = torch.full((1,), -1, **long)
        return LBVH(minus_one, minus_one, primitive_mins, primitive_maxs,
                    torch.ones((1,), dtype=torch.bool, device=device), torch.zeros((1,), **long))

    codes = morton_codes(corners.mean(dim=1))
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]
    ids = torch.arange(count, **long)

    def lcp(j):
        return longest_common_prefix(sorted_codes, ids, j)

    lcp_right, lcp_left = lcp(ids + 1), lcp(ids - 1)
    direction = (lcp_right > lcp_left).long() * 2 - 1
    delta_min = torch.minimum(lcp_left, lcp_right)

    # An upper bound of the range's length, doubled while the prefix stays
    # above delta_min (at most 2B, so ceil(log2(2B)) + 1 steps suffice).
    steps = max(1, math.ceil(math.log2(2 * count)) + 1)
    l_max = torch.full((count,), 2, **long)
    for _ in range(steps):
        l_max = torch.where(lcp(ids + l_max * direction) > delta_min, l_max * 2, l_max)
    # The range's exact length, by halving steps of the power of two l_max.
    length = torch.zeros(count, **long)
    t = l_max // 2
    for _ in range(steps + 1):
        length = torch.where((t >= 1) & (lcp(ids + (length + t) * direction) > delta_min), length + t, length)
        t = t // 2
    farthest = ids + length * direction

    # The split: the last position whose prefix with i exceeds the node's,
    # by Karras's steps ceil(l / 2), ceil(l / 4), ..., 1 (extra steps of 1
    # only move it closer).
    delta_node = lcp(farthest)
    split = torch.zeros(count, **long)
    for k in range(1, steps + 2):
        t = (length + (1 << k) - 1) >> k
        candidate = split + t
        move = (t >= 1) & (candidate <= length) & (lcp(ids + candidate * direction) > delta_node)
        split = torch.where(move, candidate, split)
    gamma = ids + split * direction + torch.clamp(direction, max=0)

    internal = count - 1
    gamma = gamma[:internal]
    low = torch.minimum(ids, farthest)[:internal]
    high = torch.maximum(ids, farthest)[:internal]
    left_internal = torch.where(low == gamma, internal + gamma, gamma)
    right_internal = torch.where(high == gamma + 1, internal + gamma + 1, gamma + 1)
    leaves = torch.full((count,), -1, **long)
    left = torch.cat([left_internal, leaves])
    right = torch.cat([right_internal, leaves])
    is_leaf = torch.arange(2 * count - 1, device=device) >= internal
    primitive_index = torch.cat([torch.full((internal,), -1, **long), order])

    sorted_mins, sorted_maxs = primitive_mins[order], primitive_maxs[order]
    aabb_min = torch.cat([_range_bounds(sorted_mins, low, high, torch.minimum), sorted_mins])
    aabb_max = torch.cat([_range_bounds(sorted_maxs, low, high, torch.maximum), sorted_maxs])
    return LBVH(left, right, aabb_min, aabb_max, is_leaf, primitive_index)


def lbvh_nodes(tree: LBVH) -> torch.Tensor:
    """The kernel's node array ``[2B - 1, 8]`` float32: min xyz and the left child, max
    xyz and the right child (a leaf: -1 and its primitive), the indices as int32 bits."""
    right = torch.where(tree.is_leaf, tree.primitive_index, tree.right)
    return torch.cat(
        [
            tree.aabb_min.float(), tree.left.to(torch.int32).view(torch.float32)[:, None],
            tree.aabb_max.float(), right.to(torch.int32).view(torch.float32)[:, None],
        ],
        dim=1,
    ).contiguous()


def ray_aabb_intersect(
    ray_origins: torch.Tensor,
    inverse_ray_directions: torch.Tensor,
    aabb_min: torch.Tensor,
    aabb_max: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab-method entry and exit distances, broadcasting over leading dimensions."""
    low = (aabb_min - ray_origins) * inverse_ray_directions
    high = (aabb_max - ray_origins) * inverse_ray_directions
    return torch.minimum(low, high).amax(dim=-1), torch.maximum(low, high).amin(dim=-1)


@torch.no_grad()
def lbvh_keep(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    blocking_primitives_corners: torch.Tensor,
    ray_primitive_indices: torch.Tensor | None,
    intersection_distances_target: torch.Tensor,
) -> torch.Tensor:
    """The flat route's keep flags ``[B]`` (1.0 or 0.0) by LBVH traversal; the arguments
    as :func:`artist_tpu_torch.raytracing.blocking.cull_primitives`'s, which it equals."""
    num, rays, points = ray_directions.shape[:3]
    dtype = ray_origins.dtype
    if ray_primitive_indices is None:
        own = torch.full((num,), -1, dtype=torch.int64, device=ray_origins.device)
    else:
        own = ray_primitive_indices.to(torch.int64).contiguous()
    nodes = lbvh_nodes(build_linear_bounding_volume_hierarchies(blocking_primitives_corners.to(dtype)))
    return lbvh_traverse(
        ray_origins.contiguous(),
        ray_directions.reshape(num, rays * points, 4).contiguous(),
        intersection_distances_target.reshape(num, rays * points).to(dtype).contiguous(),
        own,
        nodes,
    )


def lbvh_filter_blocking_planes(
    points_at_ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    blocking_primitives_corners: torch.Tensor,
    ray_to_heliostat_mapping: torch.Tensor,
    intersection_distances_target: torch.Tensor,
    stack_size: int = STACK_SIZE,
) -> torch.Tensor:
    """Keep flag ``[B]`` (bool) of each primitive that some ray of another heliostat enters
    before its target hit: the dense cull's keep-set, found by per-ray traversal.

    Parameters as the JAX package's: origins ``[M, P, 4]``, directions ``[M, R,
    P, 4]``, corners ``[B, 4, 4]``, each heliostat's own primitive ``[M]`` and
    the target distances ``[M, R, P]``. ``stack_size`` must be the kernel's 64.
    """
    if stack_size != STACK_SIZE:
        raise ValueError(f"the traversal's stack holds {STACK_SIZE} nodes, got stack_size={stack_size}")
    if blocking_primitives_corners.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=points_at_ray_origins.device)
    return lbvh_keep(
        points_at_ray_origins, ray_directions, blocking_primitives_corners, ray_to_heliostat_mapping,
        intersection_distances_target,
    ) > 0

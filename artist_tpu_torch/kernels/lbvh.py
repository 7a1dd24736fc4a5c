"""Per-ray LBVH traversal into the flat route's keep flags: a CUDA kernel and its plain version.

The JAX package traverses its linear bounding volume hierarchy with a
``vmap``-ed ``lax.while_loop`` (``artist_tpu/raytracing/lbvh.py:
lbvh_filter_blocking_planes``), not a Pallas kernel; it keeps ``[rays, B]``
flags. ``csrc/lbvh.cu``'s ``lbvh_traverse_kernel`` runs one thread a ray
with a 64-entry stack and ORs the hits into one ``[B]`` array (its head note
gives the design and the bound). The tree comes from
:func:`artist_tpu_torch.raytracing.lbvh.lbvh_nodes`.

Inputs, each contiguous: ``origins [M, P, 4]`` (ray ``i`` of a heliostat
starts at point ``i mod P``), ``directions [M, N, 4]``, ``t_target [M, N]``,
``own [M]`` (int64: the primitive each heliostat owns, -1 for none) and
``nodes [2B - 1, 8]`` (min xyz, left child, max xyz, right child; a leaf's
left is -1 and its right its primitive; the indices are int32 bits). Output:
``keep [B]``, 1.0 where a ray not owned by the primitive hits its box before
its target hit, 0.0 elsewhere: the flat route's cull flags.

:func:`lbvh_traverse` is a ``torch.library`` operator without a gradient, so a
selective checkpoint can save its output. It dispatches on the tensors'
device: a CUDA tensor launches the kernel or raises, a CPU tensor runs the
plain version. ``LAUNCHES`` counts kernel launches (never plain calls).
"""

from __future__ import annotations

import ctypes
import math

import torch

from artist_tpu_torch.kernels.build import load_library

LAUNCHES = {"lbvh_traverse": 0}
# The kernel's stack, as the JAX traversal's stack_size; a push that finds it full is dropped.
STACK_SIZE = 64
# Rays the plain version walks in lock step at once.
PLAIN_RAY_CHUNK = 1 << 20
# The traversal's inverse direction is 1 / (d + DIRECTION_OFFSET), as the cull's.
DIRECTION_OFFSET = 1e-12

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("lbvh")
        pointer = ctypes.c_void_p
        library.lbvh_traverse.argtypes = [pointer] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                                          ctypes.c_int, pointer]
        library.lbvh_traverse.restype = ctypes.c_int
        library.lbvh_stack_size.restype = ctypes.c_int
        library.lbvh_error_string.argtypes = [ctypes.c_int]
        library.lbvh_error_string.restype = ctypes.c_char_p
        if library.lbvh_stack_size() != STACK_SIZE:
            raise RuntimeError(f"csrc/lbvh.cu's stack holds {library.lbvh_stack_size()} nodes, not {STACK_SIZE}")
        _library = library
    return _library


def _check_inputs(origins, directions, t_target, own, nodes) -> None:
    """Validate what the kernel and its plain version take."""
    if origins.dim() != 3 or origins.shape[2] != 4:
        raise ValueError(f"origins must be [M, P, 4], got {tuple(origins.shape)}")
    num, points = origins.shape[:2]
    if directions.dim() != 3 or directions.shape[0] != num or directions.shape[2] != 4:
        raise ValueError(f"directions must be [M, N, 4], got {tuple(directions.shape)}")
    if points == 0 or directions.shape[1] % points:
        raise ValueError(f"the ray count ({directions.shape[1]}) must be a multiple of the points ({points})")
    if tuple(t_target.shape) != tuple(directions.shape[:2]):
        raise ValueError(f"t_target must be {tuple(directions.shape[:2])}, got {tuple(t_target.shape)}")
    if nodes.dim() != 2 or nodes.shape[1] != 8 or nodes.shape[0] % 2 != 1:
        raise ValueError(f"nodes must be [2B - 1, 8], got {tuple(nodes.shape)}")
    for name, x in (("directions", directions), ("t_target", t_target), ("nodes", nodes)):
        if x.device != origins.device or x.dtype != origins.dtype:
            raise ValueError(f"{name} must share the device and dtype of origins")
    if own.dtype != torch.int64 or own.device != origins.device or tuple(own.shape) != (num,):
        raise ValueError(f"own must be int64 [M] on {origins.device}, got {own.dtype} {tuple(own.shape)}")
    for name, x in (("origins", origins), ("directions", directions), ("t_target", t_target), ("own", own),
                    ("nodes", nodes)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origins.dtype != torch.float32:
        raise TypeError(f"the LBVH traversal takes float32 (the nodes hold int32 bits), got {origins.dtype}")


def traverse_cuda(origins, directions, t_target, own, nodes) -> torch.Tensor:
    """Launch ``lbvh_traverse_kernel``: ``keep [B]``."""
    if origins.device.type != "cuda":
        raise ValueError(f"the LBVH kernel takes CUDA tensors, got {origins.device}")
    _check_inputs(origins, directions, t_target, own, nodes)
    if origins.data_ptr() % 16 or directions.data_ptr() % 16 or nodes.data_ptr() % 16:
        raise ValueError("the LBVH kernel reads origins, directions and nodes as 16-byte vectors: align them")
    keep = torch.zeros((nodes.shape[0] + 1) // 2, dtype=torch.float32, device=origins.device)
    if t_target.numel() == 0:
        return keep
    library = _load()
    status = library.lbvh_traverse(
        origins.data_ptr(), directions.data_ptr(), t_target.data_ptr(), own.data_ptr(), nodes.data_ptr(),
        keep.data_ptr(), origins.shape[0], directions.shape[1], origins.shape[1], origins.device.index,
        torch.cuda.current_stream(origins.device).cuda_stream,
    )
    if status != 0:
        message = library.lbvh_error_string(status).decode()
        raise RuntimeError(f"lbvh_traverse kernel launch failed: {message} ({status})")
    LAUNCHES["lbvh_traverse"] += 1
    return keep


def traverse_plain(origins, directions, t_target, own, nodes, stack_size: int = STACK_SIZE,
                   ray_chunk: int = PLAIN_RAY_CHUNK, count_visits: bool = False):
    """Plain version of the kernel: the same traversal, rays in lock step, ``ray_chunk`` at a time.

    Each round pops one node of every ray that still has one, tests it with
    the cull's slab test in the same order of operations (NaN propagating),
    marks the leaves hit and pushes the children of the internal nodes hit,
    dropping a push that finds the ray's stack full. Returns ``keep [B]``, and
    with ``count_visits`` also the number of nodes the rays visited.
    """
    num, points = origins.shape[:2]
    rays = directions.shape[1]
    device = origins.device
    keep = torch.zeros((nodes.shape[0] + 1) // 2, dtype=origins.dtype, device=device)
    lo, hi = nodes[:, :3], nodes[:, 4:7]
    left = nodes[:, 3].contiguous().view(torch.int32).long()
    right = nodes[:, 7].contiguous().view(torch.int32).long()
    flat_directions = directions.reshape(-1, 4)
    flat_t = t_target.reshape(-1)
    total = num * rays
    visits = 0
    for start in range(0, total, ray_chunk):
        rows = torch.arange(start, min(start + ray_chunk, total), device=device)
        m = rows // rays
        origin = origins[m, (rows - m * rays) % points, :3]
        inverse = 1.0 / (flat_directions[rows, :3] + DIRECTION_OFFSET)
        t, owner = flat_t[rows], own[m]
        count = rows.numel()
        stack = torch.zeros((count, stack_size), dtype=torch.long, device=device)  # the root, node 0
        pointer = torch.ones(count, dtype=torch.long, device=device)
        alive = torch.arange(count, device=device)
        while alive.numel():
            pointer[alive] -= 1
            node = stack[alive, pointer[alive]]
            visits += alive.numel()
            entry = torch.full((alive.numel(),), -math.inf, dtype=origins.dtype, device=device)
            exit_ = torch.full_like(entry, math.inf)
            for a in range(3):
                t_low = (lo[node, a] - origin[alive, a]) * inverse[alive, a]
                t_high = (hi[node, a] - origin[alive, a]) * inverse[alive, a]
                entry = torch.maximum(entry, torch.minimum(t_low, t_high))
                exit_ = torch.minimum(exit_, torch.maximum(t_low, t_high))
            hit = (exit_ >= entry) & (exit_ > 1e-6) & (entry <= t[alive])
            leaf = left[node] < 0
            keep[right[node[hit & leaf & (right[node] != owner[alive])]]] = 1.0
            inner = hit & ~leaf
            pushing, children = alive[inner], node[inner]
            for child in (left[children], right[children]):
                top = pointer[pushing]
                room = top < stack_size
                stack[pushing[room], top[room]] = child[room]
                pointer[pushing] = top + room.long()
            alive = alive[pointer[alive] > 0]
    return (keep, visits) if count_visits else keep


@torch.library.custom_op("artist_tpu_torch::lbvh_traverse", mutates_args=())
def lbvh_traverse(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_target: torch.Tensor,
    own: torch.Tensor,
    nodes: torch.Tensor,
) -> torch.Tensor:
    """The flat route's keep flags ``keep [B]`` from the LBVH ``nodes`` (no gradient)."""
    if origins.is_cuda:
        return traverse_cuda(origins, directions, t_target, own, nodes)
    _check_inputs(origins, directions, t_target, own, nodes)
    return traverse_plain(origins, directions, t_target, own, nodes)

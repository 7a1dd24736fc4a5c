"""Soft blocking optical depth and the flat route's AABB cull: CUDA kernels and plain versions.

Counterparts of both routes of ``artist_tpu/kernels/blocking_pallas.py``. The
kernels live in ``csrc/blocking.cu``:

- the candidate-compacted ("grouped") route,
  ``blocking_sigma_pallas_grouped``:

  - ``blocking_sigma_forward`` replaces ``_sigma_forward_kernel`` with
    ``gated=True``: a block takes 256 surface points of one heliostat and
    first gathers the heliostat's kept candidates in ascending slot order;
    with none kept it writes zeros without reading a ray; otherwise a thread
    takes one point and its rays, four at a time, and loops over the kept
    candidates alone, leaving a pair whose sigma is exactly 0 after its
    geometry (:func:`gated_pair_exits`);
  - ``blocking_sigma_backward`` replaces ``_sigma_bwd_fused_kernel`` (and, for
    K > 16, the split ``_sigma_bwd_rays_kernel`` / ``_sigma_bwd_prims_kernel``):
    the same layout and gather; each point's origin cotangent and each ray's
    direction cotangent stored once by the thread that owns them, the
    per-candidate cotangents summed over four rays in registers, reduced in
    the block and added atomically;

- the flat route over every primitive of the field,
  ``soft_ray_blocking_mask_pallas``:

  - ``blocking_cull`` replaces ``_cull_kernel``: the AABB slab test, OR-reduced
    over every ray into a keep flag per primitive (no gradient); each warp
    first tests the bounds of its 128 rays against 32 boxes at once and runs
    the exact test only where some ray may hit, and a box found is published
    to every block at once; it equals its plain version bit for bit;
  - ``blocking_sigma_flat_forward`` replaces ``_sigma_forward_kernel`` with
    ``gated=False``: each block first gathers the kept primitives in
    ascending order, then one thread per ray loops over them alone; with
    none kept it writes zeros without reading a ray;
  - ``blocking_sigma_flat_backward`` replaces ``_sigma_bwd_rays_kernel`` and
    ``_sigma_bwd_prims_kernel`` with ``gated=False``, fused: the same gather,
    4 rays a thread, per-ray cotangents, and per-primitive cotangents summed
    over the whole field by a persistent grid and a second, fixed-order
    reduction.

What bounds them on the H100 depends on how many primitives a ray meets:
operations on the flat route and with every candidate slot kept, the ray
streams' bytes when the corridor test keeps few candidates; the source's head
note gives the bounds and what the design does about them.

Inputs, each contiguous: ``origins [M, P, 4]`` (the aligned surface points;
ray ``i`` of a heliostat starts at point ``i mod P``), ``directions [M, N, 4]``,
``t_target [M, N]`` (the ray's target-hit distance; not differentiated).
Compacted: ``columns [M, K, 16]`` (nx ny nz ux uy uz vx vy vz c0n c0u c0v uu vv
uv inv_det of each candidate) and ``keep [M, K]`` (1 for a real candidate, 0
for a padded slot). Flat: ``columns [B, 16]`` and ``keep [B]`` of every
primitive; the cull also takes ``own [M]`` (int64: the primitive each
heliostat owns, -1 for none) and ``aabb [B, 6]`` (min xyz, max xyz). sigma
is ``[M, N]``.

:func:`blocking_sigma` and :func:`blocking_sigma_flat` are ``torch.library``
operators with their own autograd formulas, and :func:`blocking_cull` one
without a gradient, so that a selective checkpoint can save their outputs
(:mod:`artist_tpu_torch.raytracing.render`). Each dispatches on the tensors'
device: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain PyTorch version defined here. There is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches (never plain calls). The sigma operators'
forward and their autograd backward each run under a span (``artist.kernels.sigma_forward``,
``artist.kernels.sigma_backward``; :func:`~artist_tpu_torch.util.logging_utils.span`), on both
routes, the kernel's launch or the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.util.logging_utils import span

LAUNCHES = {
    "blocking_sigma_forward": 0,
    "blocking_sigma_backward": 0,
    "blocking_cull": 0,
    "blocking_sigma_flat_forward": 0,
    "blocking_sigma_flat_backward": 0,
}
NUM_COLUMNS = 16
# Shared memory bounds K: 147 floats per candidate slot in the backward (its
# columns, keep, index, det and 8 warps' 16 column sums: 226 KB at K = 384).
# The flat route takes any number of primitives, in tiles.
MAX_CANDIDATES = 384
# The kernels' blocks are 256 threads; an SM of sm_90 holds at most 2048
# threads, so at most 8 such blocks at once.
KERNEL_THREADS = 256
MAX_BLOCKS_PER_SM = 8
# The cull's inverse direction is 1 / (d + CULL_DIRECTION_OFFSET), as the TPU kernel's.
CULL_DIRECTION_OFFSET = 1e-12
# Exponents of the soft gates are clamped here: e^80 stays finite in fp32.
EXP_CLAMP = 80.0
# A gate exponent of at least this makes its denominator at least e^45 > 2^64;
# two such denominators overflow their product, so sigma = 1 / inf = 0 and the
# flat kernels skip the pair's gates (csrc/blocking.cu, gates_overflow).
GATE_OVERFLOW_EXPONENT = 45.0

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("blocking")
        pointer, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        # M, N, P, K or B, softness, offset, epsilon, tail, device, stream
        sizes = [i64, i64, i32, i32, f32, f32, f32, f32, i32, pointer]
        for name, pointers in (
            ("blocking_sigma_forward", 6),
            ("blocking_sigma_backward", 9),
            ("blocking_sigma_flat_forward", 5),
        ):
            getattr(library, name).argtypes = [pointer] * pointers + sizes
        # ... the partials buffer and the most blocks it holds, then the sizes.
        library.blocking_sigma_flat_backward.argtypes = [pointer] * 9 + [i32] + sizes
        library.blocking_cull.argtypes = [pointer] * 6 + [i64, i64, i32, i32, i32, pointer]
        for name in (
            "blocking_sigma_forward", "blocking_sigma_backward", "blocking_sigma_flat_forward",
            "blocking_sigma_flat_backward", "blocking_cull",
        ):
            getattr(library, name).restype = ctypes.c_int
        library.blocking_error_string.argtypes = [ctypes.c_int]
        library.blocking_error_string.restype = ctypes.c_char_p
        _library = library
    return _library


def _check_status(library: ctypes.CDLL, name: str, status: int) -> None:
    if status != 0:
        message = library.blocking_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")


def _check_tensors(origins, directions, shapes: dict) -> None:
    """Every float tensor on the device and in the dtype of ``origins``, contiguous, of the
    shape given in ``shapes`` (name -> (tensor, shape)); rays as the kernels lay them out."""
    if origins.dim() != 3 or origins.shape[2] != 4:
        raise ValueError(f"origins must be [M, P, 4], got {tuple(origins.shape)}")
    num, points = origins.shape[:2]
    if directions.dim() != 3 or directions.shape[0] != num or directions.shape[2] != 4:
        raise ValueError(f"directions must be [M, N, 4], got {tuple(directions.shape)}")
    rays = directions.shape[1]
    if points == 0 or rays % points:
        raise ValueError(f"the ray count ({rays}) must be a multiple of the points ({points})")
    for name, (x, shape) in {"origins": (origins, None), "directions": (directions, None), **shapes}.items():
        if x.device != origins.device or x.dtype != origins.dtype:
            raise ValueError(f"{name} must share the device and dtype of origins")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if origins.device.type == "cuda":
        if origins.dtype != torch.float32:
            raise TypeError(f"the CUDA blocking kernels take float32, got {origins.dtype}")
    elif origins.device.type == "cpu":
        if origins.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the plain blocking takes float32 or float64, got {origins.dtype}")
    else:
        raise ValueError(f"no blocking kernel for device type {origins.device.type!r}")


def _check_inputs(origins, directions, t_target, columns, keep, gbar=None) -> None:
    """Validate what the compacted route's kernels and plain versions take."""
    num, rays = directions.shape[:2]
    if columns.dim() != 3 or columns.shape[0] != num or columns.shape[2] != NUM_COLUMNS:
        raise ValueError(f"columns must be [M, K, {NUM_COLUMNS}], got {tuple(columns.shape)}")
    shapes = {"t_target": (t_target, (num, rays)), "columns": (columns, None), "keep": (keep, columns.shape[:2])}
    if gbar is not None:
        shapes["gbar"] = (gbar, (num, rays))
    _check_tensors(origins, directions, shapes)
    if origins.is_cuda and columns.shape[1] > MAX_CANDIDATES:
        raise ValueError(f"at most {MAX_CANDIDATES} candidates, got {columns.shape[1]}")


def _check_flat_inputs(origins, directions, columns, keep, gbar=None) -> None:
    """Validate what the flat route's sigma kernels and plain versions take."""
    if columns.dim() != 2 or columns.shape[1] != NUM_COLUMNS:
        raise ValueError(f"columns must be [B, {NUM_COLUMNS}], got {tuple(columns.shape)}")
    shapes = {"columns": (columns, None), "keep": (keep, columns.shape[:1])}
    if gbar is not None:
        shapes["gbar"] = (gbar, directions.shape[:2])
    _check_tensors(origins, directions, shapes)


def _check_cull_inputs(origins, directions, t_target, own, aabb) -> None:
    """Validate what the cull kernel and its plain version take."""
    if aabb.dim() != 2 or aabb.shape[1] != 6:
        raise ValueError(f"aabb must be [B, 6], got {tuple(aabb.shape)}")
    _check_tensors(origins, directions, {"t_target": (t_target, directions.shape[:2]), "aabb": (aabb, None)})
    if own.dtype != torch.int64 or own.device != origins.device or tuple(own.shape) != origins.shape[:1]:
        raise ValueError(f"own must be int64 [M] on {origins.device}, got {own.dtype} {tuple(own.shape)}")
    if not own.is_contiguous():
        raise ValueError("own must be contiguous")


def _require_cuda(origins) -> None:
    """The kernels read raw pointers: every tensor must be a CUDA tensor."""
    if origins.device.type != "cuda":
        raise ValueError(f"the CUDA blocking kernels take CUDA tensors, got {origins.device}")


def _require_aligned(name: str, origins, directions) -> None:
    """The kernel ``name`` reads origins and directions as 16-byte vectors."""
    if origins.data_ptr() % 16 or directions.data_ptr() % 16:
        raise ValueError(f"the {name} kernel reads origins and directions as 16-byte vectors: align them to 16 bytes")


def _launch_args(origins, directions, count, softness, offset, epsilon) -> list:
    """M, N, P, K or B, the gate parameters, e^-softness, device and stream."""
    num, points = origins.shape[:2]
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    return [
        num, directions.shape[1], points, count,
        float(softness), float(offset), float(epsilon), math.exp(-softness),
        origins.device.index, stream,
    ]


def sigma_forward_cuda(origins, directions, t_target, columns, keep,
                       softness: float, ray_origin_offset: float, epsilon: float) -> torch.Tensor:
    """Launch ``sigma_forward_kernel``: ``sigma [M, N]``."""
    _require_cuda(origins)
    _check_inputs(origins, directions, t_target, columns, keep)
    _require_aligned("sigma forward", origins, directions)
    sigma = torch.empty(t_target.shape, dtype=torch.float32, device=origins.device)
    if sigma.numel() == 0:
        return sigma
    library = _load()
    status = library.blocking_sigma_forward(
        origins.data_ptr(), directions.data_ptr(), t_target.data_ptr(), columns.data_ptr(),
        keep.data_ptr(), sigma.data_ptr(),
        *_launch_args(origins, directions, columns.shape[1], softness, ray_origin_offset, epsilon),
    )
    _check_status(library, "blocking_sigma_forward", status)
    LAUNCHES["blocking_sigma_forward"] += 1
    return sigma


def sigma_backward_cuda(origins, directions, t_target, columns, keep, gbar,
                        softness: float, ray_origin_offset: float, epsilon: float):
    """Launch ``sigma_backward_kernel``: cotangents of origins, directions and columns."""
    _require_cuda(origins)
    _check_inputs(origins, directions, t_target, columns, keep, gbar)
    _require_aligned("sigma backward", origins, directions)
    grad_origins = torch.zeros_like(origins)
    grad_directions = torch.empty_like(directions)
    grad_columns = torch.zeros_like(columns)
    if gbar.numel() == 0:
        return grad_origins, grad_directions, grad_columns
    library = _load()
    status = library.blocking_sigma_backward(
        origins.data_ptr(), directions.data_ptr(), t_target.data_ptr(), columns.data_ptr(),
        keep.data_ptr(), gbar.data_ptr(),
        grad_origins.data_ptr(), grad_directions.data_ptr(), grad_columns.data_ptr(),
        *_launch_args(origins, directions, columns.shape[1], softness, ray_origin_offset, epsilon),
    )
    _check_status(library, "blocking_sigma_backward", status)
    LAUNCHES["blocking_sigma_backward"] += 1
    return grad_origins, grad_directions, grad_columns


def cull_cuda(origins, directions, t_target, own, aabb) -> torch.Tensor:
    """Launch ``blocking_cull_kernel``: ``keep [B]``, 1.0 for a primitive some ray may meet."""
    _require_cuda(origins)
    _check_cull_inputs(origins, directions, t_target, own, aabb)
    _require_aligned("cull", origins, directions)
    keep = torch.zeros(aabb.shape[0], dtype=torch.float32, device=origins.device)
    if keep.numel() == 0 or t_target.numel() == 0:
        return keep
    library = _load()
    num, points = origins.shape[:2]
    status = library.blocking_cull(
        origins.data_ptr(), directions.data_ptr(), t_target.data_ptr(), own.data_ptr(),
        aabb.data_ptr(), keep.data_ptr(), num, directions.shape[1], points, aabb.shape[0],
        origins.device.index, torch.cuda.current_stream(origins.device).cuda_stream,
    )
    _check_status(library, "blocking_cull", status)
    LAUNCHES["blocking_cull"] += 1
    return keep


def sigma_flat_forward_cuda(origins, directions, columns, keep,
                            softness: float, ray_origin_offset: float, epsilon: float) -> torch.Tensor:
    """Launch ``sigma_flat_forward_kernel``: ``sigma [M, N]`` over every primitive."""
    _require_cuda(origins)
    _check_flat_inputs(origins, directions, columns, keep)
    if directions.shape[0] * directions.shape[1] == 0 or columns.shape[0] == 0:
        return torch.zeros(directions.shape[:2], dtype=torch.float32, device=origins.device)
    sigma = torch.empty(directions.shape[:2], dtype=torch.float32, device=origins.device)  # the kernel writes every ray
    library = _load()
    status = library.blocking_sigma_flat_forward(
        origins.data_ptr(), directions.data_ptr(), columns.data_ptr(), keep.data_ptr(), sigma.data_ptr(),
        *_launch_args(origins, directions, columns.shape[0], softness, ray_origin_offset, epsilon),
    )
    _check_status(library, "blocking_sigma_flat_forward", status)
    LAUNCHES["blocking_sigma_flat_forward"] += 1
    return sigma


def sigma_flat_backward_cuda(origins, directions, columns, keep, gbar,
                             softness: float, ray_origin_offset: float, epsilon: float):
    """Launch ``sigma_flat_backward_kernel`` and its reduction: cotangents of origins,
    directions and columns ``[B, 16]`` (summed over every ray)."""
    _require_cuda(origins)
    _check_flat_inputs(origins, directions, columns, keep, gbar)
    grad_origins = torch.zeros_like(origins)
    if gbar.numel() == 0 or columns.shape[0] == 0:
        return grad_origins, torch.zeros_like(directions), torch.zeros_like(columns)
    grad_directions = torch.empty_like(directions)
    grad_columns = torch.empty_like(columns)
    library = _load()
    primitives = columns.shape[0]
    # Scratch: each block's column cotangents, summed in a fixed order by the
    # reduction; rows for the most blocks the persistent grid can have.
    sms = torch.cuda.get_device_properties(origins.device).multi_processor_count
    blocks = min(sms * MAX_BLOCKS_PER_SM, -(-gbar.numel() // KERNEL_THREADS))
    partials = torch.empty((blocks, primitives, NUM_COLUMNS), dtype=torch.float32, device=origins.device)
    status = library.blocking_sigma_flat_backward(
        origins.data_ptr(), directions.data_ptr(), columns.data_ptr(), keep.data_ptr(), gbar.data_ptr(),
        grad_origins.data_ptr(), grad_directions.data_ptr(), partials.data_ptr(), grad_columns.data_ptr(),
        blocks,
        *_launch_args(origins, directions, primitives, softness, ray_origin_offset, epsilon),
    )
    _check_status(library, "blocking_sigma_flat_backward", status)
    LAUNCHES["blocking_sigma_flat_backward"] += 1
    return grad_origins, grad_directions, grad_columns


def _rays(origins: torch.Tensor, directions: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(ox, oy, oz, dx, dy, dz), each ``[M, N]``; ray ``i`` starts at point ``i mod P``."""
    num, points = origins.shape[:2]
    repeats = directions.shape[1] // points
    o = origins[:, None, :, :3].expand(num, repeats, points, 3).reshape(num, -1, 3)
    return (*o.unbind(-1), *directions[..., :3].unbind(-1))


def _pair_terms(rays, column, t_target, softness, offset, epsilon):
    """One primitive against rays ``[M, N]`` (``column [M, 16]``: each heliostat's own).

    The same pair math as ``blocking_pallas.py:_pair_terms``, in the same
    order of operations. ``t_target [M, N]`` gates each pair with
    ``t <= t_target`` (the compacted route); ``None`` leaves it ungated (the
    flat route).
    """
    ox, oy, oz, dx, dy, dz = rays
    nx, ny, nz, ux, uy, uz, vx, vy, vz, c0n, c0u, c0v, suu, svv, suv, inv_det = (
        column[:, j, None] for j in range(NUM_COLUMNS)
    )
    o_dot_n = ox * nx + oy * ny + oz * nz
    o_dot_u = ox * ux + oy * uy + oz * uz
    o_dot_v = ox * vx + oy * vy + oz * vz
    d_dot_n = dx * nx + dy * ny + dz * nz
    d_dot_u = dx * ux + dy * uy + dz * uz
    d_dot_v = dx * vx + dy * vy + dz * vz
    denominator_ok = torch.abs(d_dot_n) >= epsilon
    clamped = torch.where(d_dot_n >= 0, epsilon, -epsilon).to(d_dot_n.dtype)
    inv_denominator = 1.0 / torch.where(denominator_ok, d_dot_n, clamped)
    t = (c0n - o_dot_n) * inv_denominator
    proj_u = o_dot_u + t * d_dot_u - c0u
    proj_v = o_dot_v + t * d_dot_v - c0v
    u = (proj_u * svv - proj_v * suv) * inv_det
    v = (proj_v * suu - proj_u * suv) * inv_det

    k = softness

    def exp(a):
        return torch.exp(torch.clamp(a, max=EXP_CLAMP))

    au, bu = exp(-k * u), exp(-k * (1.0 - u))
    av, bv = exp(-k * v), exp(-k * (1.0 - v))
    ct = exp(-k * (t - offset))
    tail = math.exp(-k)
    denom_u = 1.0 + au + bu + tail
    denom_v = 1.0 + av + bv + tail
    denom_t = 1.0 + ct
    numerator = 1.0 if t_target is None else (t <= t_target).to(t.dtype)
    sigma = numerator / (denom_u * denom_v * denom_t)
    return sigma, dict(
        d_dot_u=d_dot_u, d_dot_v=d_dot_v, inv_denominator=inv_denominator,
        denominator_ok=denominator_ok, t=t, proj_u=proj_u, proj_v=proj_v, u=u, v=v,
        au=au, bu=bu, av=av, bv=bv, ct=ct, denom_u=denom_u, denom_v=denom_v, denom_t=denom_t,
    )


def _pair_cotangents(rays, column, weight, t_target, gbar, softness, offset, epsilon):
    """The hand-derived cotangents of ``blocking_pallas.py:_pair_gradients`` for one
    primitive against rays ``[M, N]``, each pair weighted by ``gbar x weight``.

    Returns the six ray cotangents (origin xyz, direction xyz) and the sixteen
    column cotangents, each per pair, ``[M, N]``.
    """
    ox, oy, oz, dx, dy, dz = rays
    nx, ny, nz, ux, uy, uz, vx, vy, vz = (column[:, j, None] for j in range(9))
    suu, svv, suv, inv_det = (column[:, j, None] for j in range(12, 16))
    sigma, q = _pair_terms(rays, column, t_target, softness, offset, epsilon)
    k = softness
    base = gbar * weight * sigma
    g_uc = base * (k * (q["au"] - q["bu"]) / q["denom_u"])
    g_vc = base * (k * (q["av"] - q["bv"]) / q["denom_v"])
    g_t_front = base * (k * q["ct"] / q["denom_t"])
    g_pu = (g_uc * svv - g_vc * suv) * inv_det
    g_pv = (g_vc * suu - g_uc * suv) * inv_det
    g_t = g_t_front + g_pu * q["d_dot_u"] + g_pv * q["d_dot_v"]
    g_on = -g_t * q["inv_denominator"]
    g_dn = torch.where(q["denominator_ok"], -q["t"] * g_t * q["inv_denominator"], 0.0)
    g_du = g_pu * q["t"]
    g_dv = g_pv * q["t"]
    axes = ((nx, ux, vx), (ny, uy, vy), (nz, uz, vz))
    ray_parts = [g_on * n_a + g_pu * u_a + g_pv * v_a for n_a, u_a, v_a in axes] + [
        g_dn * n_a + g_du * u_a + g_dv * v_a for n_a, u_a, v_a in axes
    ]
    column_parts = [
        g_on * ox + g_dn * dx, g_on * oy + g_dn * dy, g_on * oz + g_dn * dz,
        g_pu * ox + g_du * dx, g_pu * oy + g_du * dy, g_pu * oz + g_du * dz,
        g_pv * ox + g_dv * dx, g_pv * oy + g_dv * dy, g_pv * oz + g_dv * dz,
        g_t * q["inv_denominator"], -g_pu, -g_pv,
        g_vc * q["proj_v"] * inv_det,
        g_uc * q["proj_u"] * inv_det,
        -(g_uc * q["proj_v"] + g_vc * q["proj_u"]) * inv_det,
        (g_uc * q["u"] + g_vc * q["v"]) / inv_det,
    ]
    return ray_parts, column_parts


def _ray_cotangents(ray_grads, points):
    """The summed per-ray cotangents -> origins ``[M, P, 4]`` (summed over each point's
    rays) and directions ``[M, N, 4]``; the fourth (homogeneous) components get zero."""
    num = ray_grads[0].shape[0]
    zero = torch.zeros_like(ray_grads[0])
    grad_origins = torch.stack(ray_grads[:3] + [zero], dim=-1)
    grad_origins = grad_origins.reshape(num, -1, points, 4).sum(dim=1)
    return grad_origins, torch.stack(ray_grads[3:] + [zero], dim=-1)


def sigma_forward_plain(origins, directions, t_target, columns, keep,
                        softness: float, ray_origin_offset: float, epsilon: float) -> torch.Tensor:
    """Plain version of the compacted forward kernel: the pair math, one candidate at a time."""
    rays = _rays(origins, directions)
    sigma = torch.zeros_like(t_target)
    for k in range(columns.shape[1]):
        pair, _ = _pair_terms(rays, columns[:, k], t_target, softness, ray_origin_offset, epsilon)
        sigma = sigma + keep[:, k, None] * pair
    return sigma


def sigma_backward_plain(origins, directions, t_target, columns, keep, gbar,
                         softness: float, ray_origin_offset: float, epsilon: float):
    """Plain version of the compacted backward kernel, one candidate at a time.

    Returns the cotangents of origins ``[M, P, 4]`` (summed over each point's
    rays), directions ``[M, N, 4]`` and columns ``[M, K, 16]`` (summed over
    the owner's rays); the fourth (homogeneous) components get zero.
    """
    rays = _rays(origins, directions)
    ray_grads = [torch.zeros_like(t_target) for _ in range(6)]
    column_grads = []
    for c in range(columns.shape[1]):
        ray_parts, column_parts = _pair_cotangents(
            rays, columns[:, c], keep[:, c, None], t_target, gbar, softness, ray_origin_offset, epsilon
        )
        ray_grads = [total + part for total, part in zip(ray_grads, ray_parts)]
        column_grads.append(torch.stack([x.sum(dim=1) for x in column_parts], dim=1))
    grad_columns = torch.stack(column_grads, dim=1) if column_grads else torch.zeros_like(columns)
    return (*_ray_cotangents(ray_grads, origins.shape[1]), grad_columns)


def cull_plain(origins, directions, t_target, own, aabb) -> torch.Tensor:
    """Plain version of the cull kernel, one primitive at a time: ``keep [B]``.

    The slab test of ``blocking_pallas.py:_cull_kernel`` in the same order of
    operations, NaN propagating through every minimum and maximum: primitive
    ``b`` is kept (1.0) when a ray not owned by ``b`` enters its AABB before
    its target hit.
    """
    ox, oy, oz, dx, dy, dz = _rays(origins, directions)
    inverses = [1.0 / (d + CULL_DIRECTION_OFFSET) for d in (dx, dy, dz)]
    keep = torch.zeros(aabb.shape[0], dtype=origins.dtype, device=origins.device)
    for b in range(aabb.shape[0]):
        entry = torch.full_like(t_target, -math.inf)
        exit_ = torch.full_like(t_target, math.inf)
        for o, inverse, low, high in zip((ox, oy, oz), inverses, aabb[b, :3], aabb[b, 3:]):
            t_low = (low - o) * inverse
            t_high = (high - o) * inverse
            entry = torch.maximum(entry, torch.minimum(t_low, t_high))
            exit_ = torch.minimum(exit_, torch.maximum(t_low, t_high))
        hit = (exit_ >= entry) & (exit_ > 1e-6) & (entry <= t_target) & (own[:, None] != b)
        keep[b] = hit.any().to(keep.dtype)
    return keep


def sigma_flat_forward_plain(origins, directions, columns, keep,
                             softness: float, ray_origin_offset: float, epsilon: float) -> torch.Tensor:
    """Plain version of the flat forward kernel: the ungated pair math, one primitive at a time."""
    num = origins.shape[0]
    rays = _rays(origins, directions)
    sigma = torch.zeros(directions.shape[:2], dtype=origins.dtype, device=origins.device)
    for b in range(columns.shape[0]):
        pair, _ = _pair_terms(
            rays, columns[b].expand(num, NUM_COLUMNS), None, softness, ray_origin_offset, epsilon
        )
        sigma = sigma + keep[b] * pair
    return sigma


def sigma_flat_backward_plain(origins, directions, columns, keep, gbar,
                              softness: float, ray_origin_offset: float, epsilon: float):
    """Plain version of the flat backward kernels, one primitive at a time.

    Returns the cotangents of origins ``[M, P, 4]``, directions ``[M, N, 4]``
    and columns ``[B, 16]`` (summed over every ray of the field).
    """
    num = origins.shape[0]
    rays = _rays(origins, directions)
    ray_grads = [torch.zeros_like(gbar) for _ in range(6)]
    column_grads = []
    for b in range(columns.shape[0]):
        ray_parts, column_parts = _pair_cotangents(
            rays, columns[b].expand(num, NUM_COLUMNS), keep[b], None, gbar, softness, ray_origin_offset, epsilon
        )
        ray_grads = [total + part for total, part in zip(ray_grads, ray_parts)]
        column_grads.append(torch.stack([x.sum() for x in column_parts]))
    grad_columns = torch.stack(column_grads) if column_grads else torch.zeros_like(columns)
    return (*_ray_cotangents(ray_grads, origins.shape[1]), grad_columns)


def gates_overflow(pair: dict, softness: float, offset: float) -> torch.Tensor:
    """Where the flat kernels skip a pair's gates, from ``_pair_terms``' terms: two of
    its three gate exponents are at least ``GATE_OVERFLOW_EXPONENT``, so the product of
    the gate denominators overflows and the pair's sigma is exactly 0."""
    k = softness
    far_u = torch.maximum(-k * pair["u"], -k * (1.0 - pair["u"])) >= GATE_OVERFLOW_EXPONENT
    far_v = torch.maximum(-k * pair["v"], -k * (1.0 - pair["v"])) >= GATE_OVERFLOW_EXPONENT
    far_t = -k * (pair["t"] - offset) >= GATE_OVERFLOW_EXPONENT
    return (far_u & far_v) | (far_t & (far_u | far_v))


def gated_pair_exits(pair: dict, t_target, weight, det, softness: float, offset: float) -> torch.Tensor:
    """Where the compacted kernels leave a (ray, kept candidate) pair after its geometry, from
    ``_pair_terms``' terms: the pair lies beyond the ray's target hit (``t > t_target``), its
    gates overflow (:func:`gates_overflow`) or its weight ``gbar x keep`` is 0, and ``t``,
    ``u``, ``v``, the weight and ``det = 1 / inv_det`` are finite. Then sigma and every
    cotangent of the pair are exactly 0. The forward passes ``keep`` and ``det = 1``."""
    zero = (pair["t"] > t_target) | gates_overflow(pair, softness, offset) | (weight == 0)
    return zero & torch.isfinite(pair["t"] + pair["u"] + pair["v"] + weight * det)


@torch.library.custom_op("artist_tpu_torch::blocking_sigma", mutates_args=())
def blocking_sigma(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_target: torch.Tensor,
    columns: torch.Tensor,
    keep: torch.Tensor,
    softness: float,
    ray_origin_offset: float,
    epsilon: float,
) -> torch.Tensor:
    """Summed soft occlusion ``sigma [M, N]`` of each ray over its heliostat's candidates."""
    args = (origins, directions, t_target, columns, keep, softness, ray_origin_offset, epsilon)
    with span("artist.kernels.sigma_forward"):
        if origins.is_cuda:
            return sigma_forward_cuda(*args)
        _check_inputs(origins, directions, t_target, columns, keep)
        return sigma_forward_plain(*args)


@torch.library.custom_op("artist_tpu_torch::blocking_sigma_backward", mutates_args=())
def blocking_sigma_backward(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_target: torch.Tensor,
    columns: torch.Tensor,
    keep: torch.Tensor,
    gbar: torch.Tensor,
    softness: float,
    ray_origin_offset: float,
    epsilon: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents of origins ``[M, P, 4]``, directions ``[M, N, 4]`` and columns ``[M, K, 16]``."""
    args = (origins, directions, t_target, columns, keep, gbar, softness, ray_origin_offset, epsilon)
    if origins.is_cuda:
        return sigma_backward_cuda(*args)
    _check_inputs(origins, directions, t_target, columns, keep, gbar)
    return sigma_backward_plain(*args)


def _setup_context(ctx, inputs, output) -> None:
    origins, directions, t_target, columns, keep, softness, offset, epsilon = inputs
    ctx.save_for_backward(origins, directions, t_target, columns, keep)
    ctx.parameters = (softness, offset, epsilon)


def _backward(ctx, gbar):
    # Unpacked before the span: under a checkpoint the unpack recomputes the chunk.
    origins, directions, t_target, columns, keep = ctx.saved_tensors
    with span("artist.kernels.sigma_backward"):
        grad_origins, grad_directions, grad_columns = blocking_sigma_backward(
            origins, directions, t_target, columns, keep, gbar.contiguous(), *ctx.parameters
        )
    return grad_origins, grad_directions, None, grad_columns, None, None, None, None


blocking_sigma.register_autograd(_backward, setup_context=_setup_context)


@torch.library.custom_op("artist_tpu_torch::blocking_cull", mutates_args=())
def blocking_cull(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_target: torch.Tensor,
    own: torch.Tensor,
    aabb: torch.Tensor,
) -> torch.Tensor:
    """The flat route's participation flags ``keep [B]`` (no gradient)."""
    if origins.is_cuda:
        return cull_cuda(origins, directions, t_target, own, aabb)
    _check_cull_inputs(origins, directions, t_target, own, aabb)
    return cull_plain(origins, directions, t_target, own, aabb)


@torch.library.custom_op("artist_tpu_torch::blocking_sigma_flat", mutates_args=())
def blocking_sigma_flat(
    origins: torch.Tensor,
    directions: torch.Tensor,
    columns: torch.Tensor,
    keep: torch.Tensor,
    softness: float,
    ray_origin_offset: float,
    epsilon: float,
) -> torch.Tensor:
    """Summed soft occlusion ``sigma [M, N]`` of each ray over every kept primitive."""
    args = (origins, directions, columns, keep, softness, ray_origin_offset, epsilon)
    with span("artist.kernels.sigma_forward"):
        if origins.is_cuda:
            return sigma_flat_forward_cuda(*args)
        _check_flat_inputs(origins, directions, columns, keep)
        return sigma_flat_forward_plain(*args)


@torch.library.custom_op("artist_tpu_torch::blocking_sigma_flat_backward", mutates_args=())
def blocking_sigma_flat_backward(
    origins: torch.Tensor,
    directions: torch.Tensor,
    columns: torch.Tensor,
    keep: torch.Tensor,
    gbar: torch.Tensor,
    softness: float,
    ray_origin_offset: float,
    epsilon: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangents of origins ``[M, P, 4]``, directions ``[M, N, 4]`` and columns ``[B, 16]``."""
    args = (origins, directions, columns, keep, gbar, softness, ray_origin_offset, epsilon)
    if origins.is_cuda:
        return sigma_flat_backward_cuda(*args)
    _check_flat_inputs(origins, directions, columns, keep, gbar)
    return sigma_flat_backward_plain(*args)


def _setup_flat_context(ctx, inputs, output) -> None:
    origins, directions, columns, keep, softness, offset, epsilon = inputs
    ctx.save_for_backward(origins, directions, columns, keep)
    ctx.parameters = (softness, offset, epsilon)


def _flat_backward(ctx, gbar):
    origins, directions, columns, keep = ctx.saved_tensors
    with span("artist.kernels.sigma_backward"):
        grad_origins, grad_directions, grad_columns = blocking_sigma_flat_backward(
            origins, directions, columns, keep, gbar.contiguous(), *ctx.parameters
        )
    return grad_origins, grad_directions, grad_columns, None, None, None, None


blocking_sigma_flat.register_autograd(_flat_backward, setup_context=_setup_flat_context)

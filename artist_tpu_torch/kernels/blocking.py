"""Soft blocking optical depth over per-heliostat candidates: CUDA kernels and plain versions.

Counterpart of the candidate-compacted ("grouped") path of
``artist_tpu/kernels/blocking_pallas.py`` (``blocking_sigma_pallas_grouped``).
The kernels live in ``csrc/blocking.cu``:

- ``blocking_sigma_forward`` replaces ``_sigma_forward_kernel`` with
  ``gated=True``: one thread per ray, a loop over the owner's K candidates
  held in shared memory.
- ``blocking_sigma_backward`` replaces ``_sigma_bwd_fused_kernel`` (and, for
  K > 16, the split ``_sigma_bwd_rays_kernel`` / ``_sigma_bwd_prims_kernel``):
  the same layout; per-ray cotangents written directly, per-candidate
  cotangents reduced in the block and added atomically.

What bounds them on the H100 depends on how many candidates the corridor
test keeps: operations when every slot is kept, the ray streams' bytes in
real fields; the source's head note gives the bound and what the design does
about it.

Inputs, each contiguous: ``origins [M, P, 4]`` (the aligned surface points;
ray ``i`` of a heliostat starts at point ``i mod P``), ``directions [M, N, 4]``,
``t_target [M, N]`` (the ray's target-hit distance; not differentiated),
``columns [M, K, 16]`` (nx ny nz ux uy uz vx vy vz c0n c0u c0v uu vv uv
inv_det of each candidate) and ``keep [M, K]`` (1 for a real candidate, 0 for
a padded slot). The output is ``sigma [M, N]``.

:func:`blocking_sigma` is a ``torch.library`` operator with its own autograd
formula, so that a selective checkpoint can save its output
(:mod:`artist_tpu_torch.raytracing.render`). Its implementation dispatches on
the tensors' device: a CUDA tensor launches the kernel or raises; a CPU
tensor runs the plain PyTorch version defined here. There is no fallback
from one to the other. ``LAUNCHES`` counts kernel launches (never plain
calls).
"""

from __future__ import annotations

import ctypes
import math

import torch

from artist_tpu_torch.kernels.build import load_library

LAUNCHES = {"blocking_sigma_forward": 0, "blocking_sigma_backward": 0}
NUM_COLUMNS = 16
# Shared memory bounds K: (17 + 8 x 16) floats per candidate in the backward.
MAX_CANDIDATES = 384
# Exponents of the soft gates are clamped here: e^80 stays finite in fp32.
EXP_CLAMP = 80.0

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("blocking")
        pointer, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        # M, N, P, K, softness, offset, epsilon, tail, device, stream
        sizes = [i64, i64, i32, i32, f32, f32, f32, f32, i32, pointer]
        library.blocking_sigma_forward.argtypes = [pointer] * 6 + sizes
        library.blocking_sigma_forward.restype = ctypes.c_int
        library.blocking_sigma_backward.argtypes = [pointer] * 9 + sizes
        library.blocking_sigma_backward.restype = ctypes.c_int
        library.blocking_error_string.argtypes = [ctypes.c_int]
        library.blocking_error_string.restype = ctypes.c_char_p
        _library = library
    return _library


def _check_status(library: ctypes.CDLL, name: str, status: int) -> None:
    if status != 0:
        message = library.blocking_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")


def _check_inputs(origins, directions, t_target, columns, keep, gbar=None) -> None:
    """Validate what the kernels and plain versions take."""
    tensors = {"origins": origins, "directions": directions, "t_target": t_target,
               "columns": columns, "keep": keep}
    if gbar is not None:
        tensors["gbar"] = gbar
    for name, x in tensors.items():
        if x.device != origins.device or x.dtype != origins.dtype:
            raise ValueError(f"{name} must share the device and dtype of origins")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origins.dim() != 3 or origins.shape[2] != 4:
        raise ValueError(f"origins must be [M, P, 4], got {tuple(origins.shape)}")
    num, points = origins.shape[:2]
    if directions.dim() != 3 or directions.shape[0] != num or directions.shape[2] != 4:
        raise ValueError(f"directions must be [M, N, 4], got {tuple(directions.shape)}")
    rays = directions.shape[1]
    if points == 0 or rays % points:
        raise ValueError(f"the ray count ({rays}) must be a multiple of the points ({points})")
    if columns.dim() != 3 or columns.shape[0] != num or columns.shape[2] != NUM_COLUMNS:
        raise ValueError(f"columns must be [M, K, {NUM_COLUMNS}], got {tuple(columns.shape)}")
    for name, x, shape in (("t_target", t_target, (num, rays)), ("keep", keep, columns.shape[:2])) + (
        (("gbar", gbar, (num, rays)),) if gbar is not None else ()
    ):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if origins.device.type == "cuda":
        if origins.dtype != torch.float32:
            raise TypeError(f"the CUDA blocking kernels take float32, got {origins.dtype}")
        if columns.shape[1] > MAX_CANDIDATES:
            raise ValueError(f"at most {MAX_CANDIDATES} candidates, got {columns.shape[1]}")
    elif origins.device.type == "cpu":
        if origins.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the plain blocking takes float32 or float64, got {origins.dtype}")
    else:
        raise ValueError(f"no blocking kernel for device type {origins.device.type!r}")


def _check_cuda_inputs(origins, *tensors) -> None:
    """The kernels read raw pointers: every tensor must be a checked CUDA tensor."""
    if origins.device.type != "cuda":
        raise ValueError(f"the CUDA blocking kernels take CUDA tensors, got {origins.device}")
    _check_inputs(origins, *tensors)


def _launch_args(origins, directions, columns, softness, offset, epsilon) -> list:
    num, points = origins.shape[:2]
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    return [
        num, directions.shape[1], points, columns.shape[1],
        float(softness), float(offset), float(epsilon), math.exp(-softness),
        origins.device.index, stream,
    ]


def sigma_forward_cuda(origins, directions, t_target, columns, keep,
                       softness: float, ray_origin_offset: float, epsilon: float) -> torch.Tensor:
    """Launch ``sigma_forward_kernel``: ``sigma [M, N]``."""
    _check_cuda_inputs(origins, directions, t_target, columns, keep)
    sigma = torch.empty(t_target.shape, dtype=torch.float32, device=origins.device)
    if sigma.numel() == 0:
        return sigma
    library = _load()
    status = library.blocking_sigma_forward(
        origins.data_ptr(), directions.data_ptr(), t_target.data_ptr(), columns.data_ptr(),
        keep.data_ptr(), sigma.data_ptr(),
        *_launch_args(origins, directions, columns, softness, ray_origin_offset, epsilon),
    )
    _check_status(library, "blocking_sigma_forward", status)
    LAUNCHES["blocking_sigma_forward"] += 1
    return sigma


def sigma_backward_cuda(origins, directions, t_target, columns, keep, gbar,
                        softness: float, ray_origin_offset: float, epsilon: float):
    """Launch ``sigma_backward_kernel``: cotangents of origins, directions and columns."""
    _check_cuda_inputs(origins, directions, t_target, columns, keep, gbar)
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
        *_launch_args(origins, directions, columns, softness, ray_origin_offset, epsilon),
    )
    _check_status(library, "blocking_sigma_backward", status)
    LAUNCHES["blocking_sigma_backward"] += 1
    return grad_origins, grad_directions, grad_columns


def _rays(origins: torch.Tensor, directions: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(ox, oy, oz, dx, dy, dz), each ``[M, N]``; ray ``i`` starts at point ``i mod P``."""
    num, points = origins.shape[:2]
    repeats = directions.shape[1] // points
    o = origins[:, None, :, :3].expand(num, repeats, points, 3).reshape(num, -1, 3)
    return (*o.unbind(-1), *directions[..., :3].unbind(-1))


def _pair_terms(rays, column, t_target, softness, offset, epsilon):
    """One candidate against every ray of its heliostat (``column [M, 16]``, rays ``[M, N]``).

    The same pair math as ``blocking_pallas.py:_pair_terms``, in the same
    order of operations.
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
    numerator = (t <= t_target).to(t.dtype)
    sigma = numerator / (denom_u * denom_v * denom_t)
    return sigma, dict(
        d_dot_u=d_dot_u, d_dot_v=d_dot_v, inv_denominator=inv_denominator,
        denominator_ok=denominator_ok, t=t, proj_u=proj_u, proj_v=proj_v, u=u, v=v,
        au=au, bu=bu, av=av, bv=bv, ct=ct, denom_u=denom_u, denom_v=denom_v, denom_t=denom_t,
    )


def sigma_forward_plain(origins, directions, t_target, columns, keep,
                        softness: float, ray_origin_offset: float, epsilon: float) -> torch.Tensor:
    """Plain version of the forward kernel: the pair math, one candidate at a time."""
    rays = _rays(origins, directions)
    sigma = torch.zeros_like(t_target)
    for k in range(columns.shape[1]):
        pair, _ = _pair_terms(rays, columns[:, k], t_target, softness, ray_origin_offset, epsilon)
        sigma = sigma + keep[:, k, None] * pair
    return sigma


def sigma_backward_plain(origins, directions, t_target, columns, keep, gbar,
                         softness: float, ray_origin_offset: float, epsilon: float):
    """Plain version of the backward kernel: the hand-derived cotangents of
    ``blocking_pallas.py:_pair_gradients``, one candidate at a time.

    Returns the cotangents of origins ``[M, P, 4]`` (summed over each point's
    rays), directions ``[M, N, 4]`` and columns ``[M, K, 16]``; the fourth
    (homogeneous) components get zero.
    """
    num, points = origins.shape[:2]
    rays = _rays(origins, directions)
    ox, oy, oz, dx, dy, dz = rays
    ray_grads = [torch.zeros_like(t_target) for _ in range(6)]
    column_grads = []
    k = softness
    for c in range(columns.shape[1]):
        column = columns[:, c]
        nx, ny, nz, ux, uy, uz, vx, vy, vz = (column[:, j, None] for j in range(9))
        suu, svv, suv, inv_det = (column[:, j, None] for j in range(12, 16))
        sigma, q = _pair_terms(rays, column, t_target, softness, ray_origin_offset, epsilon)
        base = gbar * keep[:, c, None] * sigma
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
        for axis, (n_a, u_a, v_a) in enumerate(((nx, ux, vx), (ny, uy, vy), (nz, uz, vz))):
            ray_grads[axis] = ray_grads[axis] + (g_on * n_a + g_pu * u_a + g_pv * v_a)
            ray_grads[3 + axis] = ray_grads[3 + axis] + (g_dn * n_a + g_du * u_a + g_dv * v_a)
        per_pair = [
            g_on * ox + g_dn * dx, g_on * oy + g_dn * dy, g_on * oz + g_dn * dz,
            g_pu * ox + g_du * dx, g_pu * oy + g_du * dy, g_pu * oz + g_du * dz,
            g_pv * ox + g_dv * dx, g_pv * oy + g_dv * dy, g_pv * oz + g_dv * dz,
            g_t * q["inv_denominator"], -g_pu, -g_pv,
            g_vc * q["proj_v"] * inv_det,
            g_uc * q["proj_u"] * inv_det,
            -(g_uc * q["proj_v"] + g_vc * q["proj_u"]) * inv_det,
            (g_uc * q["u"] + g_vc * q["v"]) / inv_det,
        ]
        column_grads.append(torch.stack([x.sum(dim=1) for x in per_pair], dim=1))
    zero = torch.zeros_like(t_target)
    grad_origins = torch.stack(ray_grads[:3] + [zero], dim=-1)
    grad_origins = grad_origins.reshape(num, -1, points, 4).sum(dim=1)
    grad_directions = torch.stack(ray_grads[3:] + [zero], dim=-1)
    if column_grads:
        grad_columns = torch.stack(column_grads, dim=1)
    else:
        grad_columns = torch.zeros_like(columns)
    return grad_origins, grad_directions, grad_columns


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
    origins, directions, t_target, columns, keep = ctx.saved_tensors
    grad_origins, grad_directions, grad_columns = blocking_sigma_backward(
        origins, directions, t_target, columns, keep, gbar.contiguous(), *ctx.parameters
    )
    return grad_origins, grad_directions, None, grad_columns, None, None, None, None


blocking_sigma.register_autograd(_backward, setup_context=_setup_context)

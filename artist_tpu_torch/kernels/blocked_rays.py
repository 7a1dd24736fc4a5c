"""The per-ray chain of the compacted blocking route on planar targets: CUDA kernels and their
plain versions.

Not a TPU kernel's counterpart: the JAX package leaves the chain to XLA. On the compacted
route the chain from scatter angles to the splat's inputs runs around the blocking sigma
pair (:mod:`artist_tpu_torch.kernels.blocking`, unchanged): the rays' directions and target
distances feed sigma and the corridor test, and sigma feeds the intensities.
``csrc/blocked_rays.cu`` (its head note gives the semantics, the bounds and the design) holds
five kernels, each a counted entry of :data:`LAUNCHES`:

- ``blocked_trace_forward``: the rays' directions ``[M, N, 4]`` and target distances
  ``[M, N]`` (``N = r P``) that the sigma pair reads, the splat's ``e``, ``u`` and the
  unblocked intensities ``[M, r, P]``, the rays on target ``[M]``, and per-block partial sums
  for the statistics;
- ``corridor_statistics``: each heliostat's reductions over its rays that the corridor test
  reads (:class:`~artist_tpu_torch.raytracing.blocking.HeliostatStatistics`), with no
  ``[M, r, P]`` tensor;
- ``blocked_epilogue``: given sigma, ``w`` and the rays intercepted and unblocked ``[M]``;
- ``blocked_epilogue_backward``: the cotangents of the intensities and of sigma;
- ``blocked_trace_backward``: the gradients of the preferred directions and origins
  ``[M, P, 4]`` from the cotangents of ``e``, ``u``, the intensities and sigma's of the
  directions.

:class:`BlockedTrace` and :class:`BlockedEpilogue` are the autograd Functions; with the sigma
operator between them, a checkpointed chunk launches each forward kernel twice (its
recompute) and each backward kernel once. Each dispatches on the tensors' device: a CUDA
tensor launches the kernels or raises; a CPU tensor runs the plain versions defined here,
the PyTorch chain's arithmetic in its order (the trace and the input checks are the ray
pair's, :mod:`artist_tpu_torch.kernels.rays`), the backwards derived by hand. ``LAUNCHES``
counts kernel launches (never plain-version calls). ``render.trace_rays`` imports this module
only when it traces on the compacted route.
"""

from __future__ import annotations

import ctypes

import torch

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.kernels.rays import _check_inputs, _magnitude_args, _trace_plain
from artist_tpu_torch.raytracing.blocking import HeliostatStatistics, heliostat_statistics

LAUNCHES = {
    "blocked_trace_forward": 0,
    "corridor_statistics": 0,
    "blocked_epilogue": 0,
    "blocked_epilogue_backward": 0,
    "blocked_trace_backward": 0,
}
# The forward kernel's blocks of points, and the floats of each block's partials row.
POINT_TILE = 256
PARTIALS = 8
# A statistics row: centre (3), radius, mean direction (3), least cosine, largest distance.
STATISTICS_COLUMNS = 9

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class BlockedArgs(ctypes.Structure):
    """``csrc/blocked_rays.cu``'s ``BlockedArgs``, field for field."""

    _fields_ = [
        ("preferred", ctypes.c_void_p), ("origins", ctypes.c_void_p),
        ("angles_u", ctypes.c_void_p), ("angles_e", ctypes.c_void_p),
        ("u_strides", ctypes.c_int64 * 3), ("e_strides", ctypes.c_int64 * 3),
        ("normals", ctypes.c_void_p), ("centers", ctypes.c_void_p), ("dimensions", ctypes.c_void_p),
        ("targets", ctypes.c_void_p), ("num_targets", ctypes.c_int64),
        ("magnitudes", ctypes.c_void_p), ("magnitude_stride", ctypes.c_int64), ("magnitude", ctypes.c_float),
        ("last_e", ctypes.c_float), ("last_u", ctypes.c_float),
        ("num_maps", ctypes.c_int64), ("rays", ctypes.c_int64), ("points", ctypes.c_int64),
    ]


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("blocked_rays")
        pointer, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        library.blocked_trace_forward.argtypes = [BlockedArgs] + [pointer] * 7 + [i32, pointer]
        library.corridor_statistics.argtypes = [BlockedArgs] + [pointer] * 2 + [i32, pointer]
        library.blocked_epilogue.argtypes = [pointer] * 4 + [i64, i64, f32, f32, f32, i32, pointer]
        library.blocked_epilogue_backward.argtypes = [pointer] * 5 + [i64, i64, f32, f32, f32, i32, pointer]
        library.blocked_trace_backward.argtypes = [BlockedArgs] + [pointer] * 6 + [i32, pointer]
        for name in LAUNCHES:
            getattr(library, name).restype = ctypes.c_int
        library.blocked_args_size.restype = ctypes.c_int
        library.blocked_error_string.argtypes = [ctypes.c_int]
        library.blocked_error_string.restype = ctypes.c_char_p
        if library.blocked_args_size() != ctypes.sizeof(BlockedArgs):
            raise RuntimeError(f"csrc/blocked_rays.cu's BlockedArgs takes {library.blocked_args_size()} bytes, "
                               f"BlockedArgs here {ctypes.sizeof(BlockedArgs)}")
        _library = library
    return _library


def _launch(name: str, *args) -> None:
    """Call the library's ``name`` and count the launch; raise on a refused launch."""
    library = _load()
    status = getattr(library, name)(*args)
    if status != 0:
        message = library.blocked_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def trace_forward_plain(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                        resolution: tuple[int, int]):
    """Plain version of the ray forward: directions ``[M, N, 4]``, target distances ``[M, N]``,
    ``e``, ``u`` and intensities ``[M, r, P]``, and the rays on target ``[M]`` (int64)."""
    rays = _trace_plain(preferred, origins, angles_u, angles_e, tower, targets, resolution)
    valid = rays.valid
    num, count, points = angles_u.shape
    homogeneous = preferred[:, None, :, 3].expand(num, count, points)
    directions = torch.stack([*rays.directions, homogeneous], dim=-1).reshape(num, count * points, 4)
    distances = (rays.distance * valid).reshape(num, count * points)
    intensities = magnitude * -rays.cosine * valid
    e = (resolution[0] - 1) - rays.bitmap_e * valid
    u = rays.bitmap_u * valid
    return directions, distances, e, u, intensities, torch.sum(intensities > 0, dim=(1, 2))


def corridor_statistics_plain(origins, directions, distances, rays: int) -> HeliostatStatistics:
    """Plain version of the statistics: :func:`heliostat_statistics` of the forward's outputs."""
    num, count = distances.shape
    points = count // rays
    return heliostat_statistics(
        origins, directions.reshape(num, rays, points, 4), distances.reshape(num, rays, points)
    )


def epilogue_plain(intensities, sigma, alpha: float, extinction: float, reflectivity: float):
    """Plain version of the epilogue: ``w [M, r, P]`` and the rays intercepted and unblocked
    ``[2, M]`` (int64)."""
    blocked = 1.0 - torch.exp(-alpha * sigma.reshape(intensities.shape))  # soft_ray_blocking_mask's
    w = intensities * (1.0 - blocked) * (1.0 - extinction) * reflectivity
    return w, torch.stack([torch.sum(w > 0, dim=(1, 2)), torch.sum(blocked < 1e-3, dim=(1, 2))])


def epilogue_backward_plain(grad_w, intensities, sigma, alpha: float, extinction: float, reflectivity: float):
    """Plain version of the epilogue's backward: the cotangents of the intensities
    ``[M, r, P]`` and of sigma ``[M, N]``."""
    transmitted = torch.exp(-alpha * sigma.reshape(intensities.shape))
    g = grad_w * reflectivity * (1.0 - extinction)
    grad_sigma = -alpha * (g * intensities * transmitted)
    return g * (1.0 - (1.0 - transmitted)), grad_sigma.reshape(sigma.shape)


def trace_backward_plain(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                         resolution: tuple[int, int], grad_directions, grad_e, grad_u, grad_intensities):
    """Plain version of the ray backward: the gradients of ``preferred`` and ``origins``
    ``[M, P, 4]`` (homogeneous component 0) from the cotangents of the directions
    ``[M, N, 4]``, ``e``, ``u`` and the intensities ``[M, r, P]``, derived by hand
    (``csrc/blocked_rays.cu``'s head note)."""
    rays = _trace_plain(preferred, origins, angles_u, angles_e, tower, targets, resolution)
    zero = torch.zeros((), dtype=grad_e.dtype, device=grad_e.device)
    valid = rays.valid
    g_te = torch.where(valid, -grad_e * ((resolution[0] - 1) / rays.width), zero)
    g_tu = torch.where(valid, grad_u * ((resolution[1] - 1) / rays.height), zero)
    distance = torch.where(valid, rays.distance, zero)
    de, dn, du = rays.directions
    nx, ny, nz = rays.normal
    g_t = g_te * de + g_tu * du
    g_b = g_t / torch.where(valid, rays.cosine, torch.ones_like(rays.cosine))
    g_a = -g_b * distance - torch.where(valid, grad_intensities, zero) * magnitude
    incoming = grad_directions.reshape(*grad_e.shape, 4)
    gd_e = g_te * distance + g_a * nx + incoming[..., 0]
    gd_n = g_a * ny + incoming[..., 1]
    gd_u = g_tu * distance + g_a * nz + incoming[..., 2]
    se, ce, su, cu = rays.sin_e, rays.cos_e, rays.sin_u, rays.cos_u
    columns = [
        cu * gd_e + ce * su * gd_n + se * su * gd_u,
        -su * gd_e + ce * cu * gd_n + se * cu * gd_u,
        -se * gd_n + ce * gd_u,
    ]
    grad_preferred = torch.stack([c.sum(dim=1) for c in columns] + [torch.zeros_like(preferred[..., 3])], dim=-1)
    origin_columns = [g_te - g_b * nx, -g_b * ny, g_tu - g_b * nz]
    grad_origins = torch.stack([c.sum(dim=1) for c in origin_columns] + [torch.zeros_like(origins[..., 3])], dim=-1)
    return grad_preferred, grad_origins


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _blocked_args(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                  resolution) -> tuple[BlockedArgs, tuple]:
    """The kernels' ``BlockedArgs`` and the tensors its pointers read (kept alive by the caller)."""
    planes = tuple(x.contiguous() for x in (tower.planar_normals, tower.planar_centers, tower.planar_dimensions))
    if any(x.dtype != torch.float32 or x.device != preferred.device for x in planes):
        raise ValueError("the blocked ray kernels take the tower's planar tensors as float32 on the rays' device")
    if preferred.data_ptr() % 16 or origins.data_ptr() % 16:
        raise ValueError("the blocked ray kernels read preferred and origins as 16-byte vectors: align them")
    targets = targets.to(torch.int64).contiguous()
    if isinstance(magnitude, torch.Tensor):
        magnitude = magnitude.to(torch.float32).contiguous()
    magnitude_pointer, magnitude_stride, magnitude_value = _magnitude_args(magnitude, preferred.shape[0])
    args = BlockedArgs(
        preferred.data_ptr(), origins.data_ptr(), angles_u.data_ptr(), angles_e.data_ptr(),
        (ctypes.c_int64 * 3)(*angles_u.stride()), (ctypes.c_int64 * 3)(*angles_e.stride()),
        planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), targets.data_ptr(), planes[0].shape[0],
        magnitude_pointer, magnitude_stride, magnitude_value, resolution[0] - 1, resolution[1] - 1,
        angles_u.shape[0], angles_u.shape[1], angles_u.shape[2],
    )
    return args, (planes, targets, magnitude)


def trace_forward_cuda(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                       resolution: tuple[int, int]):
    """Launch ``blocked_trace_forward_kernel``: the outputs of :func:`trace_forward_plain` and
    the per-block partials ``[M, ceil(P / 256), 8]`` that the statistics read."""
    num, count, points = angles_u.shape
    device = preferred.device
    args, alive = _blocked_args(preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution)
    directions = torch.empty((num, count * points, 4), dtype=torch.float32, device=device)
    distances = torch.empty((num, count * points), dtype=torch.float32, device=device)
    e, u, intensities = (torch.empty(angles_u.shape, dtype=torch.float32, device=device) for _ in range(3))
    on_target = torch.zeros(num, dtype=torch.int64, device=device)
    partials = torch.empty((num, -(-points // POINT_TILE), PARTIALS), dtype=torch.float32, device=device)
    if angles_u.numel() == 0:
        return directions, distances, e, u, intensities, on_target, partials
    _launch(
        "blocked_trace_forward", args, directions.data_ptr(), distances.data_ptr(), e.data_ptr(), u.data_ptr(),
        intensities.data_ptr(), partials.data_ptr(), on_target.data_ptr(), device.index, _stream(device),
    )
    del alive
    return directions, distances, e, u, intensities, on_target, partials


def corridor_statistics_cuda(preferred, origins, angles_u, angles_e, partials) -> HeliostatStatistics:
    """Launch ``corridor_statistics_kernel`` on the forward's partials."""
    num, count, points = angles_u.shape
    if partials.shape != (num, -(-points // POINT_TILE), PARTIALS) or not partials.is_contiguous():
        raise ValueError(f"partials must be the ray forward's, got {tuple(partials.shape)}")
    statistics = torch.empty((num, STATISTICS_COLUMNS), dtype=torch.float32, device=preferred.device)
    if angles_u.numel() == 0:
        statistics.fill_(float("nan"))
    else:
        # Only the rays' layout and the points are read: no tower, no target, no magnitude.
        args = BlockedArgs(
            preferred.data_ptr(), origins.data_ptr(), angles_u.data_ptr(), angles_e.data_ptr(),
            (ctypes.c_int64 * 3)(*angles_u.stride()), (ctypes.c_int64 * 3)(*angles_e.stride()),
            None, None, None, None, 0, None, 0, 0.0, 0.0, 0.0, num, count, points,
        )
        _launch("corridor_statistics", args, partials.data_ptr(), statistics.data_ptr(), preferred.device.index,
                _stream(preferred.device))
    return HeliostatStatistics(statistics[:, 0:3], statistics[:, 3], statistics[:, 4:7], statistics[:, 7],
                               statistics[:, 8])


def epilogue_cuda(intensities, sigma, alpha: float, extinction: float, reflectivity: float):
    """Launch ``blocked_epilogue_kernel``: ``w`` and the counts ``[2, M]``."""
    num = intensities.shape[0]
    w = torch.empty_like(intensities)
    counts = torch.zeros((2, num), dtype=torch.int64, device=intensities.device)
    _launch(
        "blocked_epilogue", intensities.data_ptr(), sigma.data_ptr(), w.data_ptr(), counts.data_ptr(), num,
        sigma.shape[1], float(alpha), 1.0 - extinction, reflectivity, intensities.device.index,
        _stream(intensities.device),
    )
    return w, counts


def epilogue_backward_cuda(grad_w, intensities, sigma, alpha: float, extinction: float, reflectivity: float):
    """Launch ``blocked_epilogue_backward_kernel``: the cotangents of the intensities and sigma."""
    grad_intensities = torch.empty_like(intensities)
    grad_sigma = torch.empty_like(sigma)
    _launch(
        "blocked_epilogue_backward", grad_w.data_ptr(), intensities.data_ptr(), sigma.data_ptr(),
        grad_intensities.data_ptr(), grad_sigma.data_ptr(), intensities.shape[0], sigma.shape[1], float(alpha),
        1.0 - extinction, reflectivity, intensities.device.index, _stream(intensities.device),
    )
    return grad_intensities, grad_sigma


def trace_backward_cuda(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                        resolution: tuple[int, int], grad_directions, grad_e, grad_u, grad_intensities):
    """Launch ``blocked_trace_backward_kernel``: the gradients of ``preferred`` and ``origins``."""
    args, alive = _blocked_args(preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution)
    grad_preferred = torch.empty_like(preferred)
    grad_origins = torch.empty_like(origins)
    if preferred.numel() == 0:
        return grad_preferred, grad_origins
    _launch(
        "blocked_trace_backward", args, grad_directions.data_ptr(), grad_e.data_ptr(), grad_u.data_ptr(),
        grad_intensities.data_ptr(), grad_preferred.data_ptr(), grad_origins.data_ptr(), preferred.device.index,
        _stream(preferred.device),
    )
    del alive
    return grad_preferred, grad_origins


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _or_zeros(grad, shape, like: torch.Tensor) -> torch.Tensor:
    """A cotangent as the kernels read it: contiguous, zeros where autograd gave none."""
    return torch.zeros(shape, dtype=like.dtype, device=like.device) if grad is None else grad.contiguous()


class BlockedTrace(torch.autograd.Function):
    """The chain from scatter angles to the sigma pair's and the splat's inputs, with its VJP
    in the preferred directions and origins. Outputs: directions ``[M, N, 4]``, target
    distances ``[M, N]`` (no gradient), ``e``, ``u``, intensities ``[M, r, P]``, the rays on
    target ``[M]`` and the statistics' partials (None on the CPU)."""

    @staticmethod
    def forward(ctx, preferred, origins, angles_u, angles_e, targets, magnitude, tower, resolution):
        _check_inputs(preferred, origins, angles_u, angles_e, tower, targets, magnitude)
        inputs = (preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution)
        if preferred.is_cuda:
            outputs = trace_forward_cuda(*inputs)
        else:
            outputs = (*trace_forward_plain(*inputs), None)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            magnitude_tensor = isinstance(magnitude, torch.Tensor)
            ctx.save_for_backward(preferred, origins, angles_u, angles_e, targets,
                                  *((magnitude,) if magnitude_tensor else ()))
            ctx.constants = (tower, None if magnitude_tensor else magnitude, resolution)
        ctx.mark_non_differentiable(*(x for x in (outputs[1], outputs[5], outputs[6]) if x is not None))
        ctx.set_materialize_grads(False)
        return outputs

    @staticmethod
    def backward(ctx, grad_directions, _distances, grad_e, grad_u, grad_intensities, _count, _partials):
        preferred, origins, angles_u, angles_e, targets, *magnitude = ctx.saved_tensors
        tower, scalar, resolution = ctx.constants
        magnitude = magnitude[0] if magnitude else scalar
        num, count, points = angles_u.shape
        cotangents = (
            _or_zeros(grad_directions, (num, count * points, 4), preferred),
            *(_or_zeros(g, angles_u.shape, preferred) for g in (grad_e, grad_u, grad_intensities)),
        )
        backward = trace_backward_cuda if preferred.is_cuda else trace_backward_plain
        grad_preferred, grad_origins = backward(
            preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution, *cotangents
        )
        return (
            grad_preferred if ctx.needs_input_grad[0] else None,
            grad_origins if ctx.needs_input_grad[1] else None,
            *(None,) * 6,
        )


class BlockedEpilogue(torch.autograd.Function):
    """``w = I (1 - blocked) (1 - extinction) reflectivity`` from the intensities ``[M, r, P]``
    and sigma ``[M, N]``, and the rays intercepted and unblocked ``[2, M]``, with the VJP in
    both."""

    @staticmethod
    def forward(ctx, intensities, sigma, alpha, extinction, reflectivity):
        if sigma.shape != (intensities.shape[0], intensities[0].numel()) or sigma.dtype != intensities.dtype \
                or sigma.device != intensities.device:
            raise ValueError(f"sigma must be [M, r P] beside the intensities {tuple(intensities.shape)}, got "
                             f"{tuple(sigma.shape)}")
        intensities, sigma = intensities.contiguous(), sigma.contiguous()
        epilogue = epilogue_cuda if intensities.is_cuda else epilogue_plain
        w, counts = epilogue(intensities, sigma, alpha, extinction, reflectivity)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(intensities, sigma)
            ctx.constants = (alpha, extinction, reflectivity)
        ctx.mark_non_differentiable(counts)
        ctx.set_materialize_grads(False)
        return w, counts

    @staticmethod
    def backward(ctx, grad_w, _counts):
        if grad_w is None:
            return (None,) * 5
        intensities, sigma = ctx.saved_tensors
        backward = epilogue_backward_cuda if intensities.is_cuda else epilogue_backward_plain
        grad_intensities, grad_sigma = backward(grad_w.contiguous(), intensities, sigma, *ctx.constants)
        return grad_intensities, grad_sigma, None, None, None


def blocked_trace(
    preferred_directions: torch.Tensor,
    aligned_surface_points: torch.Tensor,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    ray_magnitude: float | torch.Tensor,
    bitmap_resolution: tuple[int, int],
):
    """One chunk of rays on planar targets to the sigma pair's and the splat's inputs:
    :class:`BlockedTrace`'s outputs. The angles ``[M, r, P]`` are read in place through
    their strides."""
    return BlockedTrace.apply(
        preferred_directions.contiguous(), aligned_surface_points.contiguous(), distortions_u, distortions_e,
        target_area_indices, ray_magnitude, tower, tuple(int(x) for x in bitmap_resolution),
    )


@torch.no_grad()
def corridor_statistics(preferred, origins, angles_u, angles_e, directions, distances, partials) -> HeliostatStatistics:
    """Each heliostat's reductions over the chunk's rays for the corridor test: on the card from
    the angles and the forward's partials, on the CPU from the forward's directions and distances."""
    if preferred.is_cuda:
        return corridor_statistics_cuda(preferred.contiguous(), origins.contiguous(), angles_u, angles_e, partials)
    return corridor_statistics_plain(origins, directions, distances, angles_u.shape[1])


def blocked_epilogue(intensities, sigma, alpha: float, extinction: float, reflectivity: float):
    """``w [M, r, P]`` and the rays intercepted and unblocked ``[M]`` (int64)."""
    w, counts = BlockedEpilogue.apply(intensities, sigma, float(alpha), float(extinction), float(reflectivity))
    return w, counts[0], counts[1]

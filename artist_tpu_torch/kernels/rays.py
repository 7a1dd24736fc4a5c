"""The per-ray geometry chain from scatter angles to the splat's inputs: a CUDA kernel pair
and its plain versions.

Not a TPU kernel's counterpart: the JAX package leaves the chain to XLA
(``apply_distortion_rotation`` -> ``line_plane_intersections`` -> the
reflectivity product), which fuses it on the TPU. In PyTorch each step is its
own kernel over every ray of a chunk, and autograd keeps most of them.
``csrc/rays.cu`` computes the chain in one forward kernel,
``ray_forward_kernel``, which writes the splat's ``e``, ``u`` and ``w``
``[M, r, P]`` and each heliostat's on-target and intercepted ray counts, and
one backward kernel, ``ray_backward_kernel``, which recomputes each ray from
its inputs and sums the gradients of the preferred directions and origins
``[M, P, 4]`` over the rays (its head note gives the semantics, the bound and
the design). It covers planar targets without blocking: ``render.trace_rays``
takes it exactly there, and the PyTorch chain (``ray_splat_inputs``)
everywhere else.

:class:`RayChunk` dispatches on the tensors' device: a CUDA tensor launches
the kernels or raises; a CPU tensor runs :func:`rays_forward_plain` and
:func:`rays_backward_plain`, the same arithmetic in PyTorch, the backward
derived by hand. It saves only its inputs, and nothing when no input needs a
gradient. ``LAUNCHES`` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.util import indices

LAUNCHES = {"ray_forward": 0, "ray_backward": 0}

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class RayArgs(ctypes.Structure):
    """``csrc/rays.cu``'s ``RayArgs``, field for field."""

    _fields_ = [
        ("preferred", ctypes.c_void_p), ("origins", ctypes.c_void_p),
        ("angles_u", ctypes.c_void_p), ("angles_e", ctypes.c_void_p),
        ("u_strides", ctypes.c_int64 * 3), ("e_strides", ctypes.c_int64 * 3),
        ("normals", ctypes.c_void_p), ("centers", ctypes.c_void_p), ("dimensions", ctypes.c_void_p),
        ("targets", ctypes.c_void_p), ("num_targets", ctypes.c_int64),
        ("magnitudes", ctypes.c_void_p), ("magnitude_stride", ctypes.c_int64), ("magnitude", ctypes.c_float),
        ("last_e", ctypes.c_float), ("last_u", ctypes.c_float),
        ("keep", ctypes.c_float), ("reflectivity", ctypes.c_float),
        ("num_maps", ctypes.c_int64), ("rays", ctypes.c_int64), ("points", ctypes.c_int64),
    ]


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("rays")
        pointer, i32 = ctypes.c_void_p, ctypes.c_int
        library.ray_forward.argtypes = [RayArgs] + [pointer] * 4 + [i32, pointer]
        library.ray_backward.argtypes = [RayArgs] + [pointer] * 5 + [i32, pointer]
        library.ray_forward.restype = library.ray_backward.restype = ctypes.c_int
        library.ray_args_size.restype = ctypes.c_int
        library.ray_error_string.argtypes = [ctypes.c_int]
        library.ray_error_string.restype = ctypes.c_char_p
        if library.ray_args_size() != ctypes.sizeof(RayArgs):
            raise RuntimeError(f"csrc/rays.cu's RayArgs takes {library.ray_args_size()} bytes, "
                               f"RayArgs here {ctypes.sizeof(RayArgs)}")
        _library = library
    return _library


def _check_status(library: ctypes.CDLL, name: str, status: int) -> None:
    if status != 0:
        message = library.ray_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")


class Rays(NamedTuple):
    """One chunk's rays traced to the plane, each ``[M, r, P]`` (the target's rows ``[M, 1, 1]``)."""

    sin_e: torch.Tensor
    cos_e: torch.Tensor
    sin_u: torch.Tensor
    cos_u: torch.Tensor
    directions: tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # e, n, u
    normal: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    cosine: torch.Tensor  # d . n, negative on the front face
    distance: torch.Tensor  # 0 off the front face
    bitmap_e: torch.Tensor  # before the mask and the flip
    bitmap_u: torch.Tensor
    valid: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor


def _trace_plain(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, resolution) -> Rays:
    """The chain of ``apply_distortion_rotation`` and ``line_plane_intersections``, in
    their order of operations: the plain form of ``csrc/rays.cu``'s ``trace``."""
    last_e, last_u = resolution[0] - 1, resolution[1] - 1

    def per_map(rows: torch.Tensor, column: int) -> torch.Tensor:
        return rows[targets][:, column, None, None]

    normal = tuple(per_map(tower.planar_normals, k) for k in (indices.e, indices.n, indices.u))
    centre = tuple(per_map(tower.planar_centers, k) for k in (indices.e, indices.n, indices.u))
    width = per_map(tower.planar_dimensions, indices.target_dimensions_width)
    height = per_map(tower.planar_dimensions, indices.target_dimensions_height)
    pe, pn, pu = (preferred[:, None, :, k] for k in (indices.e, indices.n, indices.u))
    origin = tuple(origins[:, None, :, k] for k in (indices.e, indices.n, indices.u))
    b = (centre[0] - origin[0]) * normal[0] + (centre[1] - origin[1]) * normal[1] + (centre[2] - origin[2]) * normal[2]

    sin_e, cos_e = torch.sin(angles_e), torch.cos(angles_e)
    sin_u, cos_u = torch.sin(angles_u), torch.cos(angles_u)
    de = cos_u * pe - sin_u * pn
    dn = cos_e * sin_u * pe + cos_e * cos_u * pn - sin_e * pu
    du = sin_e * sin_u * pe + sin_e * cos_u * pn + cos_e * pu
    cosine = de * normal[0] + dn * normal[1] + du * normal[2]
    front = cosine < 0.0
    distance = b / torch.where(front, cosine, torch.ones_like(cosine)) * front
    bitmap_e = (origin[0] + de * distance + width / 2 - centre[0]) / width * last_e
    bitmap_u = (origin[2] + du * distance + height / 2 - centre[2]) / height * last_u
    valid = (0 <= bitmap_e) & (bitmap_e <= last_e) & (0 <= bitmap_u) & (bitmap_u <= last_u) & front
    return Rays(sin_e, cos_e, sin_u, cos_u, (de, dn, du), normal, cosine, distance, bitmap_e, bitmap_u, valid,
                width, height)


def rays_forward_plain(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                       resolution: tuple[int, int], extinction: float, reflectivity: float):
    """Plain version of the forward kernel: the splat's ``(e, u, w)``, each ``[M, r, P]``,
    and the counts ``[2, M]`` (int64) of rays on target and intercepted."""
    rays = _trace_plain(preferred, origins, angles_u, angles_e, tower, targets, resolution)
    intensities = magnitude * -rays.cosine * rays.valid
    w = intensities * (1.0 - extinction) * reflectivity
    e = (resolution[0] - 1) - rays.bitmap_e * rays.valid
    u = rays.bitmap_u * rays.valid
    counts = torch.stack([torch.sum(intensities > 0, dim=(1, 2)), torch.sum(w > 0, dim=(1, 2))])
    return e, u, w, counts


def rays_backward_plain(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                        resolution: tuple[int, int], extinction: float, reflectivity: float,
                        grad_e, grad_u, grad_w):
    """Plain version of the backward kernel: the gradients of ``preferred`` and ``origins``
    ``[M, P, 4]`` (homogeneous component 0) from the cotangents of ``(e, u, w)``, derived
    by hand (``csrc/rays.cu``'s head note). Invalid rays contribute 0."""
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
    g_a = -g_b * distance - torch.where(valid, grad_w, zero) * (magnitude * (1.0 - extinction) * reflectivity)
    gd_e = g_te * distance + g_a * nx
    gd_n = g_a * ny
    gd_u = g_tu * distance + g_a * nz
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


def _magnitude_args(magnitude, num_maps: int) -> tuple[int | None, int, float]:
    """The kernel's (pointer, stride, value) of ``magnitude``: a float, or a tensor of one value
    or of one value a heliostat (``[M, 1, 1]``)."""
    if not isinstance(magnitude, torch.Tensor):
        return None, 0, float(magnitude)
    if magnitude.numel() == 1:
        return magnitude.data_ptr(), 0, 0.0
    if tuple(magnitude.shape) == (num_maps, 1, 1):
        return magnitude.data_ptr(), 1, 0.0
    raise ValueError(f"the ray kernels take a ray_magnitude of one value or [M, 1, 1], got {tuple(magnitude.shape)}")


def _ray_args(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude, resolution,
              extinction: float, reflectivity: float) -> tuple[RayArgs, tuple]:
    """The kernels' ``RayArgs`` and the tensors its pointers read (kept alive by the caller)."""
    planes = tuple(x.contiguous() for x in (tower.planar_normals, tower.planar_centers, tower.planar_dimensions))
    if any(x.dtype != torch.float32 or x.device != preferred.device for x in planes):
        raise ValueError("the ray kernels take the tower's planar tensors as float32 on the rays' device")
    targets = targets.to(torch.int64).contiguous()
    if isinstance(magnitude, torch.Tensor):
        magnitude = magnitude.to(torch.float32).contiguous()
    magnitude_pointer, magnitude_stride, magnitude_value = _magnitude_args(magnitude, preferred.shape[0])
    args = RayArgs(
        preferred.data_ptr(), origins.data_ptr(), angles_u.data_ptr(), angles_e.data_ptr(),
        (ctypes.c_int64 * 3)(*angles_u.stride()), (ctypes.c_int64 * 3)(*angles_e.stride()),
        planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), targets.data_ptr(), planes[0].shape[0],
        magnitude_pointer, magnitude_stride, magnitude_value, resolution[0] - 1, resolution[1] - 1,
        1.0 - extinction, reflectivity, angles_u.shape[0], angles_u.shape[1], angles_u.shape[2],
    )
    return args, (planes, targets, magnitude)


def rays_forward_cuda(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                      resolution: tuple[int, int], extinction: float, reflectivity: float):
    """Launch ``ray_forward_kernel``: ``(e, u, w)`` ``[M, r, P]`` and the counts ``[2, M]``."""
    args, alive = _ray_args(preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution,
                            extinction, reflectivity)
    outputs = tuple(torch.empty(angles_u.shape, dtype=torch.float32, device=preferred.device) for _ in range(3))
    counts = torch.zeros((2, angles_u.shape[0]), dtype=torch.int64, device=preferred.device)
    if angles_u.numel() == 0:
        return (*outputs, counts)
    library = _load()
    status = library.ray_forward(
        args, *(x.data_ptr() for x in outputs), counts.data_ptr(), preferred.device.index,
        torch.cuda.current_stream(preferred.device).cuda_stream,
    )
    del alive
    _check_status(library, "ray_forward", status)
    LAUNCHES["ray_forward"] += 1
    return (*outputs, counts)


def rays_backward_cuda(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude,
                       resolution: tuple[int, int], extinction: float, reflectivity: float,
                       grad_e, grad_u, grad_w):
    """Launch ``ray_backward_kernel``: the gradients of ``preferred`` and ``origins`` ``[M, P, 4]``."""
    grads = tuple(g.contiguous() for g in (grad_e, grad_u, grad_w))
    if any(g.shape != angles_u.shape or g.dtype != torch.float32 for g in grads):
        raise ValueError(f"the cotangents must be float32 {tuple(angles_u.shape)}")
    args, alive = _ray_args(preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution,
                            extinction, reflectivity)
    grad_preferred = torch.empty_like(preferred)
    grad_origins = torch.empty_like(origins)
    if preferred.numel() == 0:
        return grad_preferred, grad_origins
    library = _load()
    status = library.ray_backward(
        args, *(g.data_ptr() for g in grads), grad_preferred.data_ptr(), grad_origins.data_ptr(),
        preferred.device.index, torch.cuda.current_stream(preferred.device).cuda_stream,
    )
    del alive
    _check_status(library, "ray_backward", status)
    LAUNCHES["ray_backward"] += 1
    return grad_preferred, grad_origins


def _check_inputs(preferred, origins, angles_u, angles_e, tower: SolarTower, targets, magnitude) -> None:
    """Validate what the kernels and the plain versions take."""
    if preferred.dim() != 3 or preferred.shape[2] != 4 or origins.shape != preferred.shape:
        raise ValueError(f"preferred and origins must be one [M, P, 4], got {tuple(preferred.shape)} and "
                         f"{tuple(origins.shape)}")
    num_maps, points = preferred.shape[:2]
    if angles_u.dim() != 3 or angles_u.shape != angles_e.shape or angles_u.shape[0] != num_maps \
            or angles_u.shape[2] != points:
        raise ValueError(f"the angles must be [{num_maps}, r, {points}], got {tuple(angles_u.shape)} and "
                         f"{tuple(angles_e.shape)}")
    if tuple(targets.shape) != (num_maps,) or targets.dtype.is_floating_point:
        raise ValueError(f"target_area_indices must be integer [{num_maps}], got {targets.dtype} {tuple(targets.shape)}")
    dtype, device = preferred.dtype, preferred.device
    for name, x in (("origins", origins), ("distortions_u", angles_u), ("distortions_e", angles_e)):
        if x.dtype != dtype or x.device != device:
            raise ValueError(f"{name} must share the dtype and device of the preferred directions")
    if targets.device != device or (isinstance(magnitude, torch.Tensor) and magnitude.device != device):
        raise ValueError("target_area_indices and a tensor ray_magnitude must lie on the rays' device")
    planes = (tower.planar_normals, tower.planar_centers, tower.planar_dimensions)
    if any(x.requires_grad for x in planes) or (isinstance(magnitude, torch.Tensor) and magnitude.requires_grad):
        raise ValueError("the ray kernels give no gradient of the tower or of ray_magnitude")
    if device.type == "cuda":
        if dtype != torch.float32:
            raise TypeError(f"the ray kernels take float32, got {dtype}")
    elif device.type != "cpu":
        raise ValueError(f"no ray kernels for device type {device.type!r}")


class RayChunk(torch.autograd.Function):
    """The chain from scatter angles to the splat's ``(e, u, w)`` and the ray counts, with
    its VJP in the preferred directions and origins.

    CUDA tensors launch the kernels in ``csrc/rays.cu``; CPU tensors run the plain
    versions above.
    """

    @staticmethod
    def forward(ctx, preferred, origins, angles_u, angles_e, targets, magnitude, tower, resolution,
                extinction, reflectivity):
        _check_inputs(preferred, origins, angles_u, angles_e, tower, targets, magnitude)
        inputs = (preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution, extinction,
                  reflectivity)
        forward = rays_forward_cuda if preferred.is_cuda else rays_forward_plain
        e, u, w, counts = forward(*inputs)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            magnitude_tensor = isinstance(magnitude, torch.Tensor)
            ctx.save_for_backward(preferred, origins, angles_u, angles_e, targets,
                                  *((magnitude,) if magnitude_tensor else ()))
            ctx.constants = (tower, None if magnitude_tensor else magnitude, resolution, extinction, reflectivity)
        ctx.mark_non_differentiable(counts)
        return e, u, w, counts

    @staticmethod
    def backward(ctx, grad_e, grad_u, grad_w, _):
        preferred, origins, angles_u, angles_e, targets, *magnitude = ctx.saved_tensors
        tower, scalar, resolution, extinction, reflectivity = ctx.constants
        magnitude = magnitude[0] if magnitude else scalar
        backward = rays_backward_cuda if preferred.is_cuda else rays_backward_plain
        grad_preferred, grad_origins = backward(
            preferred, origins, angles_u, angles_e, tower, targets, magnitude, resolution, extinction, reflectivity,
            grad_e, grad_u, grad_w,
        )
        return (
            grad_preferred if ctx.needs_input_grad[0] else None,
            grad_origins if ctx.needs_input_grad[1] else None,
            *(None,) * 8,
        )


def ray_chunk(
    preferred_directions: torch.Tensor,
    aligned_surface_points: torch.Tensor,
    distortions_u: torch.Tensor,
    distortions_e: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    ray_magnitude: float | torch.Tensor,
    bitmap_resolution: tuple[int, int],
    ray_extinction_factor: float,
    mirror_reflectivity: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of rays on planar targets without blocking, from scatter angles to the splat.

    Parameters
    ----------
    preferred_directions, aligned_surface_points : torch.Tensor
        Mirror reflections and ray origins ``[M, P, 4]``.
    distortions_u, distortions_e : torch.Tensor
        The chunk's scatter angles ``[M, r, P]``, read in place through their strides.
    tower : SolarTower
        Its planar target areas (``target_area_indices`` ``[M]`` index them).

    Returns
    -------
    tuple of torch.Tensor
        ``bitmap_e``, ``bitmap_u`` and the final intensities ``[M, r, P]`` (the
        splat's inputs, as :func:`~artist_tpu_torch.raytracing.render.ray_splat_inputs`
        gives them), and the rays on target and intercepted ``[M]`` (int64).
    """
    e, u, w, counts = RayChunk.apply(
        preferred_directions.contiguous(), aligned_surface_points.contiguous(), distortions_u, distortions_e,
        target_area_indices, ray_magnitude, tower, tuple(int(x) for x in bitmap_resolution),
        float(ray_extinction_factor), float(mirror_reflectivity),
    )
    return e, u, w, counts[0], counts[1]

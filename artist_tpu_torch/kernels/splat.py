"""Differentiable bilinear splat: hand-written CUDA kernels and their plain versions.

Counterpart of ``artist_tpu/kernels/splat_pallas.py`` (``bilinear_splat_pallas``
with ``compute_dtype=float32``). The kernels live in ``csrc/splat.cu``:

- ``splat_forward`` replaces ``_splat_fwd_kernel`` with ``band_accumulate_kernel``,
  which also serves the formulation tool's per-ray accumulate
  (:mod:`artist_tpu_torch.kernels.splat_scatter`): a heliostat's map is cut
  into as few bands of rows as fit one thread block's shared memory
  (:func:`band_layout`); one block per (band, heliostat) reads all the
  heliostat's rays, adds the taps that land in its rows into its band with
  shared-memory atomics, and stores the band whole: no other block writes
  those pixels.
- ``splat_backward`` replaces ``_splat_bwd_kernel``: a four-tap gather of the
  cotangent over the rays as one flat sequence, lane l of a warp taking rays
  l, l + 32, ... of the warp's share, so that each warp-wide load covers 32
  consecutive rays; 4 rays a thread where a map's rays are dense on it, 1
  where they are sparse (fewer rays than a sixteenth of its pixels), every
  load of a thread issued before one is used; any N and any storage offset;
  no atomics, so two launches give the same bits. The dynamic-window
  splat's backward (:mod:`artist_tpu_torch.kernels.splat_window`) launches the
  same kernel on its ``[M, r, P]`` rays in place (:func:`backward_gather`),
  counted under its own name.

Both are bound by bytes on the H100: the forward by the rays and the maps it
writes; the backward by its ray streams where a map's rays are dense, and by
the 32-byte sectors of the cotangent its taps fall on where they are sparse
(the PAINT reconstruction's ``[4000, 1000]`` batch reads 5.2 M sectors for
3.3 M valid rays). The source's head note gives the bounds, the times and
what the design does about them. They are built with ``nvcc`` at first use
(:mod:`artist_tpu_torch.kernels.build`; plain C interface, loaded with
``ctypes``) and launch on PyTorch's current stream.

:class:`BilinearSplat` dispatches on the tensors' device: a CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain PyTorch version
defined here (``splat_forward_plain``, a 4-tap ``index_add_`` scatter, and
``splat_backward_plain``, the same 4-tap gather in PyTorch). There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches (never plain-version calls), so a run can
show that its main path went through the kernels.

:func:`splat_windowed` is the counterpart of ``bilinear_splat_windowed``: the
same kernels at a per-heliostat window's size, placed into the map, dropping
the rays outside the window (:func:`windowed_drop_fraction`).
"""

from __future__ import annotations

import ctypes

import torch

from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.util.logging_utils import span

LAUNCHES = {"splat_forward": 0, "splat_backward": 0}
# The forward's shared memory beyond its band: 4 floats, so that the band can
# start at the map's offset modulo 16 bytes.
BAND_PAD_BYTES = 16

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bind(library: ctypes.CDLL) -> ctypes.CDLL:
    """``library`` (a build of ``csrc/splat.cu``) with its functions' argument and result types."""
    pointer, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sizes = [i64, i64, i32, i32]  # M, N, H, W
    # The forward takes the rows a band between the sizes and the device and stream.
    library.splat_forward.argtypes = [pointer] * 4 + sizes + [i32, i32, pointer]
    library.splat_backward.argtypes = [pointer] * 7 + sizes + [i32, pointer]
    library.splat_shared_limit.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    names = ["splat_forward", "splat_backward", "splat_shared_limit"]
    # The gather with 64-bit indices forced (backward_gather's ``wide``); a build of an
    # earlier splat.cu, as tools/backward_turns.py loads one, lacks it.
    if hasattr(library, "splat_backward_wide"):
        library.splat_backward_wide.argtypes = library.splat_backward.argtypes
        names.append("splat_backward_wide")
    for name in names:
        getattr(library, name).restype = ctypes.c_int
    library.splat_error_string.argtypes = [ctypes.c_int]
    library.splat_error_string.restype = ctypes.c_char_p
    return library


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        _library = bind(load_library("splat"))
    return _library


def _check_status(library: ctypes.CDLL, name: str, status: int) -> None:
    if status != 0:
        message = library.splat_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")


def _check_rays(e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, dims: tuple[int, ...] = (2,)) -> None:
    """Validate the ray streams the kernels and plain versions take: ``[M, N]`` (or, where
    ``dims`` allows it, ``[M, r, P]``), contiguous, one shape, device and dtype. Written
    for few tensor attribute reads: the kernel wrappers run it at every launch."""
    if e.dim() not in dims:
        raise ValueError(f"bitmap_e must be {' or '.join(('[M, N]', '[M, r, P]')[d - 2] for d in dims)}, "
                         f"got shape {tuple(e.shape)}")
    shape, dtype, device = e.shape, e.dtype, e.device
    if u.shape != shape or w.shape != shape or u.dtype != dtype or w.dtype != dtype or u.device != device \
            or w.device != device:
        raise ValueError("bitmap_e, bitmap_u and intensities must share shape, device and dtype")
    if not (e.is_contiguous() and u.is_contiguous() and w.is_contiguous()):
        raise ValueError("bitmap_e, bitmap_u and intensities must be contiguous")
    if device.type == "cuda":
        if dtype != torch.float32:
            raise TypeError(f"the CUDA splat takes float32, got {dtype}")
    elif device.type == "cpu":
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the plain splat takes float32 or float64, got {dtype}")
    else:
        raise ValueError(f"no splat for device type {device.type!r}")


def _check_bitmap(height: int, width: int) -> None:
    if height < 2 or width < 2:
        raise ValueError(f"bitmap must be at least 2 x 2, got {height} x {width}")


def _launch_args(e: torch.Tensor, height: int, width: int) -> list:
    """The sizes, device and stream of a launch on ``[M, ...]`` rays: M maps of the rest."""
    num_maps = e.shape[0]
    rays_per_map = e.numel() // num_maps if num_maps else 0
    stream = torch.cuda.current_stream(e.device).cuda_stream
    return [num_maps, rays_per_map, height, width, e.device.index, stream]


def band_layout(height: int, width: int, shared_bytes: int) -> int:
    """The forward kernel's rows a band for ``[M, height, width]`` fp32 maps: the fewest
    bands whose rows fit one block's shared memory (``shared_bytes``, the per-block
    opt-in limit), as equal as they can be. Raises if one row does not fit."""
    rows = (shared_bytes - BAND_PAD_BYTES) // (4 * width)
    if rows < 1:
        raise ValueError(f"a row of {width} fp32 pixels does not fit {shared_bytes} bytes of shared memory")
    bands = -(-height // rows)
    return -(-height // bands)


def shared_limit(device: torch.device) -> int:
    """The card's per-block opt-in limit of shared memory, in bytes."""
    library = _load()
    limit = ctypes.c_int(0)
    _check_status(library, "splat_shared_limit", library.splat_shared_limit(device.index, limit))
    return limit.value


def band_forward(e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Launch ``band_accumulate_kernel``: ``[M, N]`` rays -> ``[M, H, W]`` bitmaps. Every
    pixel is written by its band's block, so the output is not zeroed first. The
    callers count the launch under their own names."""
    if e.numel() == 0:
        return torch.zeros((e.shape[0], height, width), dtype=torch.float32, device=e.device)
    out = torch.empty((e.shape[0], height, width), dtype=torch.float32, device=e.device)
    library = _load()
    status = library.splat_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), e.shape[0], e.shape[1], height, width,
        band_layout(height, width, shared_limit(e.device)), e.device.index,
        torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "band_accumulate", status)
    return out


def splat_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Launch the forward kernel: ``[M, N]`` rays -> ``[M, H, W]`` bitmaps."""
    out = band_forward(e, u, w, height, width)
    if e.numel():
        LAUNCHES["splat_forward"] += 1
    return out


def backward_gather(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, g: torch.Tensor, height: int, width: int,
    wide: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``splat_backward_kernel``: per-ray (de, du, dw), each of the rays' shape
    (``[M, N]``, or any ``[M, ...]`` whose rest is a map's rays). The callers count the
    launch under their own names. ``wide`` takes the kernel's 64-bit-index instantiation
    whatever the sizes (otherwise only past 2^31 rays or cotangent elements), for
    ``chip_smoke.py``'s check of it."""
    grads = tuple(torch.empty_like(e) for _ in range(3))
    if e.numel() == 0:
        return grads
    library = _load()
    status = (library.splat_backward_wide if wide else library.splat_backward)(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), g.data_ptr(),
        *(x.data_ptr() for x in grads),
        *_launch_args(e, height, width),
    )
    _check_status(library, "splat_backward", status)
    return grads


def splat_backward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
    height: int, width: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``splat_backward_kernel``: per-ray (de, du, dw), each ``[M, N]``."""
    grads = backward_gather(e, u, w, g, height, width)
    if e.numel():
        LAUNCHES["splat_backward"] += 1
    return grads


def _cells(e: torch.Tensor, u: torch.Tensor, height: int, width: int):
    """Lower cells, fractions and the strict-bounds mask, tested in float first."""
    lower_e = torch.floor(e)
    lower_u = torch.floor(u)
    valid = (lower_e >= 0) & (lower_e <= width - 2) & (lower_u >= 0) & (lower_u <= height - 2)
    zero = torch.zeros_like(e)
    frac_e = torch.where(valid, e - lower_e, zero)
    frac_u = torch.where(valid, u - lower_u, zero)
    offset = torch.where(valid, lower_u * width + lower_e, zero).long()
    return offset, frac_e, frac_u, valid


def splat_forward_plain(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Plain version of the forward kernel: a 4-tap ``index_add_`` scatter."""
    num_maps = e.shape[0]
    offset, fe, fu, valid = _cells(e, u, height, width)
    weight = torch.where(valid, w, torch.zeros_like(w))
    base = offset + torch.arange(num_maps, device=e.device)[:, None] * (height * width)
    ids = torch.cat([base, base + 1, base + width, base + width + 1], dim=1)
    values = torch.cat(
        [
            weight * (1.0 - fu) * (1.0 - fe),
            weight * (1.0 - fu) * fe,
            weight * fu * (1.0 - fe),
            weight * fu * fe,
        ],
        dim=1,
    )
    out = torch.zeros(num_maps * height * width, dtype=e.dtype, device=e.device)
    out.index_add_(0, ids.reshape(-1), values.reshape(-1))
    return out.reshape(num_maps, height, width)


def splat_backward_plain(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
    height: int, width: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the same 4-tap gather and formulas."""
    offset, fe, fu, valid = _cells(e, u, height, width)
    flat = g.reshape(g.shape[0], height * width)

    def tap(shift: int) -> torch.Tensor:
        return torch.gather(flat, 1, offset + shift)

    g00, g01, g10, g11 = tap(0), tap(1), tap(width), tap(width + 1)
    zero = torch.zeros_like(e)
    dw = (1.0 - fu) * (1.0 - fe) * g00 + (1.0 - fu) * fe * g01 + fu * (1.0 - fe) * g10 + fu * fe * g11
    de = w * ((1.0 - fu) * (g01 - g00) + fu * (g11 - g10))
    du = w * ((1.0 - fe) * (g10 - g00) + fe * (g11 - g01))
    return (
        torch.where(valid, de, zero),
        torch.where(valid, du, zero),
        torch.where(valid, dw, zero),
    )


class BilinearSplat(torch.autograd.Function):
    """``[M, N]`` ray coordinates and weights -> ``[M, H, W]`` flux, with its VJP.

    CUDA tensors launch the kernels in ``csrc/splat.cu``; CPU tensors run the
    plain versions above.
    """

    @staticmethod
    def forward(ctx, e, u, w, height: int, width: int):
        with span("artist.kernels.splat_forward"):
            _check_rays(e, u, w)
            _check_bitmap(height, width)
            ctx.save_for_backward(e, u, w)
            ctx.bitmap_shape = (height, width)
            if e.is_cuda:
                return splat_forward_cuda(e, u, w, height, width)
            return splat_forward_plain(e, u, w, height, width)

    @staticmethod
    def backward(ctx, g):
        # Unpacked before the span: under a checkpointed ray chunk the unpack recomputes
        # the chunk's rays, the geometry's work and not the splat's.
        e, u, w = ctx.saved_tensors
        with span("artist.kernels.splat_backward"):
            height, width = ctx.bitmap_shape
            g = g.contiguous()
            if g.shape != (e.shape[0], height, width) or g.device != e.device or g.dtype != e.dtype:
                raise ValueError(f"cotangent of shape {tuple(g.shape)} does not match the bitmaps")
            if e.is_cuda:
                de, du, dw = splat_backward_cuda(e, u, w, g, height, width)
            else:
                de, du, dw = splat_backward_plain(e, u, w, g, height, width)
            return de, du, dw, None, None


def splat(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
) -> torch.Tensor:
    """Differentiable bilinear splat, ``[M, N]`` rays -> ``[M, height_u, width_e]``.

    ``bitmap_resolution`` is (width_e, height_u). No flip.
    """
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    return BilinearSplat.apply(bitmap_e, bitmap_u, intensities, height, width)


def _window_offsets(bitmap_e, bitmap_u, intensities, resolution, window):
    """Per-heliostat window origins ``[M]`` (int64, no gradient, clamped inside):
    the intensity-weighted spot centre less half the window."""
    width, height = resolution
    w, e, u = intensities.detach(), bitmap_e.detach(), bitmap_u.detach()
    total = torch.sum(w, dim=1) + 1e-12
    center_e = torch.sum(e * w, dim=1) / total
    center_u = torch.sum(u * w, dim=1) / total
    offset_e = torch.clamp(torch.floor(center_e - window / 2), 0, width - window).long()
    offset_u = torch.clamp(torch.floor(center_u - window / 2), 0, height - window).long()
    return offset_e, offset_u


def splat_windowed(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    window: int,
) -> torch.Tensor:
    """Windowed splat, ``[M, N]`` rays -> ``[M, height_u, width_e]``: the counterpart
    of ``bilinear_splat_windowed``.

    Each heliostat splats into a ``window`` x ``window`` square at its
    intensity-weighted spot centre (no gradient through the origin), through
    :class:`BilinearSplat` on local coordinates, and the square is placed into
    a zero map. Lossy by design: rays outside the window are dropped
    (:func:`windowed_drop_fraction` says how much). ``window >= max(W, H)`` is
    the full splat.
    """
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    window = int(window)
    if window >= max(width, height):
        return splat(bitmap_e, bitmap_u, intensities, bitmap_resolution)
    offset_e, offset_u = _window_offsets(bitmap_e, bitmap_u, intensities, (width, height), window)
    local_e = bitmap_e - offset_e[:, None].to(bitmap_e.dtype)
    local_u = bitmap_u - offset_u[:, None].to(bitmap_u.dtype)
    windows = splat(local_e, local_u, intensities, (window, window))  # [M, window, window]
    num = windows.shape[0]
    span = torch.arange(window, device=windows.device)
    rows = (torch.arange(num, device=windows.device) * height + offset_u)[:, None, None] + span[None, :, None]
    pixels = rows * width + offset_e[:, None, None] + span[None, None, :]
    out = torch.zeros(num * height * width, dtype=windows.dtype, device=windows.device)
    return out.index_add(0, pixels.reshape(-1), windows.reshape(-1)).reshape(num, height, width)


def windowed_drop_fraction(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    window: int,
) -> torch.Tensor:
    """The share of the in-bitmap intensity that :func:`splat_windowed` drops (0-d)."""
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    offset_e, offset_u = _window_offsets(bitmap_e, bitmap_u, intensities, (width, height), int(window))

    def in_bounds(e, u, w_limit, h_limit):
        lower_e, lower_u = torch.floor(e), torch.floor(u)
        return (lower_e >= 0) & (lower_e <= w_limit - 2) & (lower_u >= 0) & (lower_u <= h_limit - 2)

    full = in_bounds(bitmap_e, bitmap_u, width, height)
    local = in_bounds(bitmap_e - offset_e[:, None], bitmap_u - offset_u[:, None], window, window)
    zero = torch.zeros_like(intensities)
    w = torch.where(full, intensities, zero)
    kept = torch.where(local, w, zero)
    return 1.0 - torch.sum(kept) / (torch.sum(w) + 1e-12)

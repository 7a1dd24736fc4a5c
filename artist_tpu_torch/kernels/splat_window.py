"""Dynamic-window bilinear splat: hand-written CUDA kernels and their plain versions.

Counterpart of ``bilinear_splat_dynamic_window`` in
``artist_tpu/kernels/splat_pallas.py`` (with ``compute_dtype=float32``) and of
the 2-D window forward ``dyn2d_forward`` of ``tools/splat_formulation_bench.py``.
The kernels live in ``csrc/splat_window.cu``:

- ``splat_dynamic_window_forward`` replaces ``_dyn_fwd_kernel`` with
  ``band_accumulate_kernel<true>`` (``csrc/splat_band.cuh``), the full
  splat's forward kernel that also plans each block of ``block`` rays: as on
  the TPU, each heliostat's map is held on chip across all its ray blocks
  (here in bands of rows, one thread block each), every deposit lands in its
  rows there, whether its block fits its window or falls back to the whole
  map, and the kernel derives every block's window and counts the fitting
  ones;
- ``splat_dynamic_window_backward`` replaces ``_dyn_bwd_kernel``: a fitting
  block copies the touched rectangle of the cotangent into shared memory and
  gathers its rays' four taps there; deterministic;
- ``splat_window_2d_forward`` replaces ``_dyn2d_fwd_kernel``: one thread block
  per block of ``block`` rays finds its 96 x 128 window, adds a fitting
  block's deposits into a tile of that size in shared memory and flushes the
  touched rectangle to the map; a block that does not fit adds straight into
  the map; forward only, as in the tool.

The window of a block (:func:`dyn_offsets`, :func:`window_2d_offsets`) is the
TPU kernels' exactly: rows from the 8-aligned floor of the block's least
valid ``u`` (columns 128-aligned), clamped into the bitmap; the block fits
when its largest valid ``u`` (and ``e``) leaves room for the deposit row
below it. No ray is ever dropped: a block that does not fit takes the full
map. The kernels find the window themselves; the plain versions take it from
those functions, add a fitting block's deposits into its own window slice
(asserting that none falls outside it) and place the slices into the map.

:class:`BilinearSplatDynamicWindow` dispatches on the tensors' device: a CUDA
tensor launches the kernels or raises; a CPU tensor runs the plain versions.
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.kernels.splat import _check_bitmap, _check_rays, band_layout, shared_limit

LAUNCHES = {
    "splat_dynamic_window_forward": 0,
    "splat_dynamic_window_backward": 0,
    "splat_window_2d_forward": 0,
}
# Rays per block (the TPU kernel's DYN_RAY_BLOCK); read at each call.
RAY_BLOCK = 1024
ROW_ALIGN = 8
COLUMN_ALIGN = 128
# The formulation tool's 2-D windows: rows x columns.
WINDOW_2D = (96, 128)
# Padding of a ragged last block, as the TPU kernel pads: fails the bounds.
_PAD_COORDINATE = -10.0

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("splat_window")
        pointer, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        # M, N, H, W, then the rows a band or the block, the window and the device and stream.
        sizes = [i64, i64, i32, i32, i32]
        library.splat_window_band_forward.argtypes = [pointer] * 5 + sizes + [i32, i32, i32, pointer]
        library.splat_window_forward.argtypes = [pointer] * 5 + sizes + [i32, i32, i32, pointer]
        library.splat_window_backward.argtypes = [pointer] * 7 + sizes + [i32, i32, pointer]
        library.splat_window_shared_limit.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        names = ("splat_window_band_forward", "splat_window_forward", "splat_window_backward",
                 "splat_window_shared_limit")
        for name in names:
            getattr(library, name).restype = ctypes.c_int
        library.splat_window_error_string.argtypes = [ctypes.c_int]
        library.splat_window_error_string.restype = ctypes.c_char_p
        _library = library
    return _library


def _check_status(library: ctypes.CDLL, name: str, status: int) -> None:
    if status != 0:
        message = library.splat_window_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")


def _ray_block(block: int | None) -> int:
    block = RAY_BLOCK if block is None else int(block)
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    return block


def _check_window(window: int, height: int) -> None:
    if window % ROW_ALIGN or window > height:
        raise ValueError(f"window ({window}) must be a multiple of 8 and <= height")


def _check_shared(library: ctypes.CDLL, device: torch.device, tile_bytes: int) -> None:
    limit = ctypes.c_int(0)
    _check_status(library, "splat_window_shared_limit", library.splat_window_shared_limit(device.index, limit))
    if tile_bytes > limit.value:
        raise ValueError(f"a {tile_bytes}-byte window tile exceeds the card's {limit.value} bytes of shared memory")


# --------------------------------------------------------------------------- #
# Windows (gradient-free, plain PyTorch on either device).
# --------------------------------------------------------------------------- #


def _blocks(x: torch.Tensor, value: float, block: int) -> torch.Tensor:
    """``[M, N]`` -> ``[M, nb, block]``, the ragged last block padded with ``value``."""
    num, n = x.shape
    padded = -(-n // block) * block
    if padded != n:
        x = torch.nn.functional.pad(x, (0, padded - n), value=value)
    return x.reshape(num, padded // block, block)


def _valid(lower_e: torch.Tensor, lower_u: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return (lower_e >= 0) & (lower_e <= width - 2) & (lower_u >= 0) & (lower_u <= height - 2)


def _extents(e: torch.Tensor, u: torch.Tensor, height: int, width: int, block: int):
    """Per block: least and largest valid u and e ``[M, nb]``, and whether any ray is valid."""
    eb = _blocks(e.detach(), _PAD_COORDINATE, block)
    ub = _blocks(u.detach(), _PAD_COORDINATE, block)
    valid = _valid(torch.floor(eb), torch.floor(ub), height, width)
    big = torch.tensor(1e9, dtype=eb.dtype, device=e.device)
    min_u = torch.where(valid, ub, big).amin(dim=2)
    max_u = torch.where(valid, ub, -big).amax(dim=2)
    min_e = torch.where(valid, eb, big).amin(dim=2)
    max_e = torch.where(valid, eb, -big).amax(dim=2)
    return min_u, max_u, min_e, max_e, valid.any(dim=2)


def _origin(least: torch.Tensor, align: int, limit: int) -> torch.Tensor:
    """floor(least) rounded down to a multiple of ``align``, clamped into [0, limit]."""
    raw = torch.floor(least).to(torch.int64)
    return torch.clamp(torch.div(raw, align, rounding_mode="floor") * align, 0, limit)


def dyn_offsets(
    e: torch.Tensor, u: torch.Tensor, height: int, width: int, window: int, block: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block row-window origins and fit flags, each ``[M * nb]`` int32.

    The port of ``_dyn_offsets``: a block fits when every in-bounds deposit
    row lies in [ou, ou + window), i.e. max u <= ou + window - 2, with ou the
    8-aligned floor of the least valid u clamped into the bitmap. Validity is
    the in-bounds test, not w > 0. A block with no valid ray fits at 0.
    """
    _check_window(window, height)
    min_u, max_u, _, _, any_valid = _extents(e, u, height, width, _ray_block(block))
    ou = _origin(min_u, ROW_ALIGN, height - window)
    fits = ~any_valid | (max_u <= ou.to(max_u.dtype) + window - 2)
    ou = torch.where(any_valid, ou, torch.zeros_like(ou))
    return ou.reshape(-1).to(torch.int32), fits.reshape(-1).to(torch.int32)


def window_2d_offsets(
    e: torch.Tensor,
    u: torch.Tensor,
    height: int,
    width: int,
    window_u: int = WINDOW_2D[0],
    window_e: int = WINDOW_2D[1],
    block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block row and column window origins and fit flags, each ``[M * nb]`` int32:
    ``dyn2d_forward``'s offsets (rows 8-aligned, columns 128-aligned)."""
    _check_window_2d(window_u, window_e, height, width)
    min_u, max_u, min_e, max_e, any_valid = _extents(e, u, height, width, _ray_block(block))
    ou = _origin(min_u, ROW_ALIGN, height - window_u)
    oe = _origin(min_e, COLUMN_ALIGN, width - window_e)
    fits = ~any_valid | (
        (max_u <= ou.to(max_u.dtype) + window_u - 2) & (max_e <= oe.to(max_e.dtype) + window_e - 2)
    )
    zero = torch.zeros_like(ou)
    ou, oe = torch.where(any_valid, ou, zero), torch.where(any_valid, oe, zero)
    return tuple(x.reshape(-1).to(torch.int32) for x in (ou, oe, fits))


def _check_window_2d(window_u: int, window_e: int, height: int, width: int) -> None:
    _check_window(window_u, height)
    if window_e % COLUMN_ALIGN or window_e > width:
        raise ValueError(f"column window ({window_e}) must be a multiple of 128 and <= width")


# --------------------------------------------------------------------------- #
# Plain versions.
# --------------------------------------------------------------------------- #


class _BlockRays:
    """Rays cut into blocks ``[M, nb, block]``: cells, fractions, validity and
    each valid ray's place in its block's window ``(ou, oe)``."""

    def __init__(self, e, u, w, height, width, block, window_u, window_e, ou, oe, fits):
        self.num, self.rays = e.shape
        eb = _blocks(e, _PAD_COORDINATE, block)
        ub = _blocks(u, _PAD_COORDINATE, block)
        self.w = _blocks(w, 0.0, block)
        self.blocks = eb.shape[1]
        lower_e, lower_u = torch.floor(eb), torch.floor(ub)
        self.valid = _valid(lower_e, lower_u, height, width)
        zero = torch.zeros_like(eb)
        self.fe = torch.where(self.valid, eb - lower_e, zero)
        self.fu = torch.where(self.valid, ub - lower_u, zero)
        self.row = torch.where(self.valid, lower_u, zero).long()
        self.col = torch.where(self.valid, lower_e, zero).long()
        shape = (self.num, self.blocks, 1)
        self.ou, self.oe = ou.long().reshape(shape), oe.long().reshape(shape)
        self.fits = fits.bool().reshape(shape)
        self.windowed = self.valid & self.fits
        local_row, local_col = self.row - self.ou, self.col - self.oe
        inside = (local_row >= 0) & (local_row + 1 < window_u) & (local_col >= 0) & (local_col + 1 < window_e)
        if not bool((inside | ~self.windowed).all()):
            raise AssertionError("a deposit of a fitting block falls outside its window")
        slot = torch.arange(self.num * self.blocks, device=e.device).reshape(shape)
        # Lower-left tap: in the block's window slice, or in the heliostat's map.
        self.window_base = torch.where(self.windowed, (slot * window_u + local_row) * window_e + local_col, 0)
        heliostat = torch.arange(self.num, device=e.device).reshape(-1, 1, 1)
        self.map_base = torch.where(self.valid, (heliostat * height + self.row) * width + self.col, 0)

    def unblock(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.num, -1)[:, : self.rays]


def _taps(base: torch.Tensor, stride: int) -> torch.Tensor:
    return torch.cat([base, base + 1, base + stride, base + stride + 1], dim=-1)


def _window_pixels(ou, oe, height, width, window_u, window_e, blocks) -> torch.Tensor:
    """Flat map index of every element of every block's window slice."""
    heliostat = torch.arange(ou.numel(), device=ou.device) // blocks
    rows = (heliostat * height + ou.long())[:, None, None] + torch.arange(window_u, device=ou.device)[None, :, None]
    cols = oe.long()[:, None, None] + torch.arange(window_e, device=ou.device)[None, None, :]
    return (rows * width + cols).reshape(-1)


def _window_forward_plain(e, u, w, height, width, block, window_u, window_e, ou, oe, fits) -> torch.Tensor:
    """Each fitting block's taps into its own ``[window_u, window_e]`` slice at (ou, oe),
    placed into the map afterwards; the other blocks' taps into the map directly."""
    rays = _BlockRays(e, u, w, height, width, block, window_u, window_e, ou, oe, fits)
    weight = torch.where(rays.valid, rays.w, torch.zeros_like(rays.w))
    fe, fu = rays.fe, rays.fu
    values = torch.cat(
        [weight * (1.0 - fu) * (1.0 - fe), weight * (1.0 - fu) * fe, weight * fu * (1.0 - fe), weight * fu * fe],
        dim=-1,
    )
    zero = torch.zeros_like(values)
    slots = ou.numel()
    slices = torch.zeros(slots * window_u * window_e, dtype=e.dtype, device=e.device)
    slices.index_add_(
        0, _taps(rays.window_base, window_e).reshape(-1), torch.where(rays.windowed.repeat(1, 1, 4), values, zero).reshape(-1)
    )
    out = torch.zeros(rays.num * height * width, dtype=e.dtype, device=e.device)
    spilled = rays.valid & ~rays.fits
    out.index_add_(0, _taps(rays.map_base, width).reshape(-1), torch.where(spilled.repeat(1, 1, 4), values, zero).reshape(-1))
    out.index_add_(0, _window_pixels(ou, oe, height, width, window_u, window_e, rays.blocks), slices)
    return out.reshape(rays.num, height, width)


def splat_dynamic_window_forward_plain(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int, window: int,
    block: int | None = None,
) -> torch.Tensor:
    """Plain version of the dynamic-window forward: per-block ``[window, W]`` slices at ``ou``."""
    block = _ray_block(block)
    ou, fits = dyn_offsets(e, u, height, width, window, block)
    return _window_forward_plain(e, u, w, height, width, block, window, width, ou, torch.zeros_like(ou), fits)


def splat_window_2d_forward_plain(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int,
    window_u: int = WINDOW_2D[0], window_e: int = WINDOW_2D[1], block: int | None = None,
) -> torch.Tensor:
    """Plain version of the 2-D window forward: per-block ``[window_u, window_e]`` slices."""
    block = _ray_block(block)
    ou, oe, fits = window_2d_offsets(e, u, height, width, window_u, window_e, block)
    return _window_forward_plain(e, u, w, height, width, block, window_u, window_e, ou, oe, fits)


def splat_dynamic_window_backward_plain(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, g: torch.Tensor, height: int, width: int,
    window: int, block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the dynamic-window backward: a fitting block's rays gather
    their four taps from its ``[window, W]`` slice of ``g``, the others from ``g``."""
    block = _ray_block(block)
    ou, fits = dyn_offsets(e, u, height, width, window, block)
    rays = _BlockRays(e, u, w, height, width, block, window, width, ou, torch.zeros_like(ou), fits)
    flat = g.reshape(-1)
    slices = flat[_window_pixels(ou, torch.zeros_like(ou), height, width, window, width, rays.blocks)]

    def tap(shift: int) -> torch.Tensor:
        return torch.where(rays.fits, slices[rays.window_base + shift], flat[rays.map_base + shift])

    g00, g01, g10, g11 = tap(0), tap(1), tap(width), tap(width + 1)
    fe, fu, weight = rays.fe, rays.fu, rays.w
    zero = torch.zeros_like(fe)
    dw = (1.0 - fu) * (1.0 - fe) * g00 + (1.0 - fu) * fe * g01 + fu * (1.0 - fe) * g10 + fu * fe * g11
    de = weight * ((1.0 - fu) * (g01 - g00) + fu * (g11 - g10))
    du = weight * ((1.0 - fe) * (g10 - g00) + fe * (g11 - g01))
    return tuple(rays.unblock(torch.where(rays.valid, x, zero)) for x in (de, du, dw))


# --------------------------------------------------------------------------- #
# Kernel wrappers.
# --------------------------------------------------------------------------- #


def _check_launch(e, u, w, height: int, width: int, window_u: int, window_e: int | None) -> None:
    """What the kernels take: the rays' layout, a bitmap of 2 x 2 or more, a window inside it."""
    _check_rays(e, u, w)
    if not e.is_cuda:
        raise ValueError(f"the kernels take CUDA tensors, got {e.device}")
    _check_bitmap(height, width)
    if window_e is None:
        _check_window(window_u, height)
    else:
        _check_window_2d(window_u, window_e, height, width)


def window_band_rows(rays_per_map: int, height: int, width: int, shared_bytes: int, block: int | None = None) -> int:
    """The row-window forward kernel's rows a band for ``[M, rays_per_map]`` rays onto
    ``[M, height, width]`` maps: :func:`artist_tpu_torch.kernels.splat.band_layout` of the
    per-block limit ``shared_bytes`` less two ints for each ray block of a heliostat (a
    band's block keeps them for the ray blocks it plans). Raises if one row does not fit."""
    return band_layout(height, width, shared_bytes - 8 * -(-rays_per_map // _ray_block(block)))


def splat_dynamic_window_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int, window: int,
    block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``band_accumulate_kernel<true>``: ``[M, N]`` rays -> ``[M, H, W]`` bitmaps, and
    the number of blocks that fit their window (``[1]`` int32)."""
    _check_launch(e, u, w, height, width, window, None)
    block = _ray_block(block)
    fitting = torch.zeros(1, dtype=torch.int32, device=e.device)
    if e.numel() == 0:
        return torch.zeros((e.shape[0], height, width), dtype=torch.float32, device=e.device), fitting
    out = torch.empty((e.shape[0], height, width), dtype=torch.float32, device=e.device)
    library = _load()
    band_rows = window_band_rows(e.shape[1], height, width, shared_limit(e.device), block)
    status = library.splat_window_band_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), fitting.data_ptr(),
        e.shape[0], e.shape[1], height, width, band_rows, block, window,
        e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "splat_dynamic_window_forward", status)
    LAUNCHES["splat_dynamic_window_forward"] += 1
    return out, fitting


def splat_window_2d_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int,
    window_u: int = WINDOW_2D[0], window_e: int = WINDOW_2D[1], block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``dynamic_window_forward_kernel<true>``: bitmaps and the number of fitting blocks."""
    _check_launch(e, u, w, height, width, window_u, window_e)
    out = torch.zeros((e.shape[0], height, width), dtype=torch.float32, device=e.device)
    fitting = torch.zeros(1, dtype=torch.int32, device=e.device)
    if e.numel() == 0:
        return out, fitting
    library = _load()
    _check_shared(library, e.device, 4 * window_u * window_e)
    status = library.splat_window_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), fitting.data_ptr(),
        e.shape[0], e.shape[1], height, width, _ray_block(block), window_u, window_e,
        e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "splat_window_2d_forward", status)
    LAUNCHES["splat_window_2d_forward"] += 1
    return out, fitting


def splat_dynamic_window_backward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, g: torch.Tensor, height: int, width: int,
    window: int, block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``dynamic_window_backward_kernel``: per-ray (de, du, dw), each ``[M, N]``."""
    _check_launch(e, u, w, height, width, window, None)
    if g.shape != (e.shape[0], height, width) or g.device != e.device or g.dtype != e.dtype or not g.is_contiguous():
        raise ValueError(f"cotangent of shape {tuple(g.shape)} does not match the bitmaps")
    grads = tuple(torch.empty_like(e) for _ in range(3))
    if e.numel() == 0:
        return grads
    library = _load()
    _check_shared(library, e.device, 4 * window * width)
    status = library.splat_window_backward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), g.data_ptr(), *(x.data_ptr() for x in grads),
        e.shape[0], e.shape[1], height, width, _ray_block(block), window,
        e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "splat_dynamic_window_backward", status)
    LAUNCHES["splat_dynamic_window_backward"] += 1
    return grads


# --------------------------------------------------------------------------- #
# Entry points.
# --------------------------------------------------------------------------- #


class BilinearSplatDynamicWindow(torch.autograd.Function):
    """``[M, N]`` rays -> ``[M, H, W]`` flux through per-block row windows, with its VJP.

    CUDA tensors launch the kernels in ``csrc/splat_window.cu``; CPU tensors
    run the plain versions above.
    """

    @staticmethod
    def forward(ctx, e, u, w, height: int, width: int, window: int, block: int):
        _check_rays(e, u, w)
        _check_bitmap(height, width)
        _check_window(window, height)
        ctx.save_for_backward(e, u, w)
        ctx.sizes = (height, width, window, block)
        if e.is_cuda:
            return splat_dynamic_window_forward_cuda(e, u, w, height, width, window, block)[0]
        return splat_dynamic_window_forward_plain(e, u, w, height, width, window, block)

    @staticmethod
    def backward(ctx, g):
        e, u, w = ctx.saved_tensors
        height, width, window, block = ctx.sizes
        g = g.contiguous()
        if g.shape != (e.shape[0], height, width) or g.device != e.device or g.dtype != e.dtype:
            raise ValueError(f"cotangent of shape {tuple(g.shape)} does not match the bitmaps")
        if e.is_cuda:
            grads = splat_dynamic_window_backward_cuda(e, u, w, g, height, width, window, block)
        else:
            grads = splat_dynamic_window_backward_plain(e, u, w, g, height, width, window, block)
        return (*grads, None, None, None, None)


def splat_dynamic_window(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    window: int = 96,
    block: int | None = None,
) -> torch.Tensor:
    """Exact bilinear splat with per-ray-block row windows, ``[M, N]`` rays ->
    ``[M, height_u, width_e]``. ``bitmap_resolution`` is (width_e, height_u);
    ``block`` defaults to ``RAY_BLOCK``. No flip. Rays ordered point-major over
    spatially tiled surface points (:func:`artist_tpu_torch.raytracing.splatting.point_tile_order`)
    give compact blocks, most of which fit the window."""
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    return BilinearSplatDynamicWindow.apply(
        bitmap_e, bitmap_u, intensities, height, width, int(window), _ray_block(block)
    )


def window_2d_forward(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    window_u: int = WINDOW_2D[0],
    window_e: int = WINDOW_2D[1],
    block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The tool's 2-D window splat forward (no gradient): ``[M, N]`` rays ->
    ``[M, height_u, width_e]`` bitmaps, and the fraction of blocks that fit
    their window (a 0-d float32 tensor on the rays' device)."""
    _check_rays(bitmap_e, bitmap_u, intensities)
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    _check_bitmap(height, width)
    _check_window_2d(window_u, window_e, height, width)
    block = _ray_block(block)
    blocks = bitmap_e.shape[0] * -(-bitmap_e.shape[1] // block)
    if bitmap_e.is_cuda:
        out, fitting = splat_window_2d_forward_cuda(
            bitmap_e, bitmap_u, intensities, height, width, window_u, window_e, block
        )
        return out, fitting[0].float() / max(blocks, 1)
    ou, oe, fits = window_2d_offsets(bitmap_e, bitmap_u, height, width, window_u, window_e, block)
    out = _window_forward_plain(
        bitmap_e, bitmap_u, intensities, height, width, block, window_u, window_e, ou, oe, fits
    )
    return out, fits.float().mean()

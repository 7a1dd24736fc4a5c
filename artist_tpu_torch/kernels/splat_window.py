"""Dynamic-window bilinear splat: hand-written CUDA kernels and their plain versions.

Counterpart of ``bilinear_splat_dynamic_window`` in
``artist_tpu/kernels/splat_pallas.py`` (with ``compute_dtype=float32``) and of
the 2-D window forward ``dyn2d_forward`` of ``tools/splat_formulation_bench.py``.

The rays of a heliostat form a sequence cut into blocks of ``block`` rays,
and each block gets a window: rows from the 8-aligned floor of the block's
least valid ``u`` (columns 128-aligned), clamped into the bitmap; the block
fits when its largest valid ``u`` (and ``e``) leaves room for the deposit row
below it (:func:`dyn_offsets`, :func:`window_2d_offsets`, the TPU kernels'
windows exactly). No ray is ever dropped: a block that does not fit takes the
full map. The sequence is the JAX package's point-major order, but the rays
are read where they lie: the streams are ``[M, r, P]``, ray ``j`` of surface
point ``p`` at ``[:, j, p]``, and the sequence takes point ``point_order[0]``'s
``r`` rays, then ``point_order[1]``'s, and so on (without an order, the points
in index order; ``[M, N]`` streams are a sequence of their own, as ``[M, 1, N]``).

- ``splat_dynamic_window_forward`` replaces ``_dyn_fwd_kernel`` with
  ``band_accumulate_kernel<kRowWindows>`` (``csrc/splat_band.cuh``), the full
  splat's forward, which holds each heliostat's map on chip in bands of rows
  and reads the rays in place; it also plans every block's window through the
  order and counts the fitting ones;
- ``splat_dynamic_window_backward`` replaces ``_dyn_bwd_kernel`` with the
  full splat's gather (``splat.cu``'s ``splat_backward_kernel``) on the rays
  in place: the window changes no cotangent (``csrc/splat_window.cu``'s head
  note says why);
- ``splat_window_2d_forward`` replaces ``_dyn2d_fwd_kernel`` with
  ``band_accumulate_kernel<kTileWindows>``, planning rows and columns;
  forward only, as in the tool.

The plain versions are faithful to the TPU kernels: they take each block's
window from those functions, add a fitting block's deposits into its own
window slice (asserting that none falls outside it), place the slices into
the map, and gather a fitting block's cotangents from its slice of ``g``.
They find each ray's block from the order without reordering the streams.

:class:`BilinearSplatDynamicWindow` dispatches on the tensors' device: a CUDA
tensor launches the kernels or raises; a CPU tensor runs the plain versions.
There is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes
import importlib

import torch

from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.kernels.splat import _check_bitmap, _check_rays, band_layout, shared_limit
from artist_tpu_torch.util.logging_utils import span

# The module, not the function of the same name that the package exports.
_splat = importlib.import_module("artist_tpu_torch.kernels.splat")

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
# Largest grid.y of the band kernel: heliostats beyond it share thread blocks.
_MAX_GRID_Y = 65535
# A coordinate beyond every valid one, for the extents of blocks without a valid ray.
_FAR = 1e9

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("splat_window")
        pointer, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        # M, N, H, W, the rows a band, the block and the window; then the order and the
        # rays a point (row windows) or the column window (2-D); the device and stream.
        sizes = [i64, i64, i32, i32, i32, i32, i32]
        library.splat_window_band_forward.argtypes = [pointer] * 5 + sizes + [pointer, i32, i32, pointer]
        library.splat_window_2d_band_forward.argtypes = [pointer] * 5 + sizes + [i32, i32, pointer]
        library.splat_window_shared_limit.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        for name in ("splat_window_band_forward", "splat_window_2d_band_forward", "splat_window_shared_limit"):
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


def _check_window_2d(window_u: int, window_e: int, height: int, width: int) -> None:
    _check_window(window_u, height)
    if window_e % COLUMN_ALIGN or window_e > width:
        raise ValueError(f"column window ({window_e}) must be a multiple of 128 and <= width")


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _layout(e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, point_order: torch.Tensor | None) -> tuple[int, int]:
    """The rays a point ``r`` and the points ``P`` of the streams (``[M, N]`` is ``r = 1``),
    after checking the streams as the splat does and the order's shape, type and device."""
    _check_rays(e, u, w, (2, 3) if point_order is None else (3,))
    rays_per_point, points = (1, e.shape[1]) if e.dim() == 2 else (e.shape[1], e.shape[2])
    if point_order is not None:
        if point_order.shape != (points,) or point_order.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"point_order must be int32 or int64 [{points}], got {point_order.dtype} "
                             f"{tuple(point_order.shape)}")
        if point_order.device != e.device:
            raise ValueError(f"point_order lies on {point_order.device}, the rays on {e.device}")
    return rays_per_point, points


# --------------------------------------------------------------------------- #
# Windows (gradient-free, plain PyTorch on either device).
# --------------------------------------------------------------------------- #


def sequence_blocks(
    rays_per_point: int, points: int, block: int, point_order: torch.Tensor | None = None, device=None
) -> tuple[torch.Tensor, int]:
    """Each ray's block in the point-major sequence, ``[r * P]`` int64 in the streams'
    own layout (ray ``j`` of point ``p`` at ``j * P + p``), and the blocks a heliostat.
    ``point_order`` must be a permutation of ``range(P)``."""
    position = torch.arange(points, device=device)
    if point_order is not None:
        order = point_order.long()
        if not torch.equal(torch.sort(order).values, position):
            raise ValueError("point_order must be a permutation of range(P)")
        position = torch.empty_like(position)
        position[order] = torch.arange(points, device=device)
    sequence = position[None, :] * rays_per_point + torch.arange(rays_per_point, device=device)[:, None]
    return torch.div(sequence.reshape(-1), block, rounding_mode="floor"), -(-rays_per_point * points // block)


def _valid(lower_e: torch.Tensor, lower_u: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return (lower_e >= 0) & (lower_e <= width - 2) & (lower_u >= 0) & (lower_u <= height - 2)


def _extents(e: torch.Tensor, u: torch.Tensor, height: int, width: int, ids: torch.Tensor, blocks: int):
    """Per block: least and largest valid u and e ``[M, nb]``, and whether any ray is valid."""
    e, u = _flat(e.detach()), _flat(u.detach())
    valid = _valid(torch.floor(e), torch.floor(u), height, width)
    index = ids.expand(e.shape[0], -1)

    def reduce(x: torch.Tensor, fill: float, how: str) -> torch.Tensor:
        start = torch.full((x.shape[0], blocks), fill, dtype=x.dtype, device=x.device)
        return start.scatter_reduce(1, index, torch.where(valid, x, torch.full_like(x, fill)), how)

    min_u, max_u = reduce(u, _FAR, "amin"), reduce(u, -_FAR, "amax")
    min_e, max_e = reduce(e, _FAR, "amin"), reduce(e, -_FAR, "amax")
    return min_u, max_u, min_e, max_e, min_u <= max_u


def _origin(least: torch.Tensor, align: int, limit: int) -> torch.Tensor:
    """floor(least) rounded down to a multiple of ``align``, clamped into [0, limit]."""
    raw = torch.floor(least).to(torch.int64)
    return torch.clamp(torch.div(raw, align, rounding_mode="floor") * align, 0, limit)


def _row_windows(e, u, height: int, width: int, window: int, ids: torch.Tensor, blocks: int):
    min_u, max_u, _, _, any_valid = _extents(e, u, height, width, ids, blocks)
    ou = _origin(min_u, ROW_ALIGN, height - window)
    fits = ~any_valid | (max_u <= ou.to(max_u.dtype) + window - 2)
    ou = torch.where(any_valid, ou, torch.zeros_like(ou))
    return ou.reshape(-1).to(torch.int32), fits.reshape(-1).to(torch.int32)


def _sequence_of(e: torch.Tensor, block: int, point_order: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """:func:`sequence_blocks` of ``[M, N]`` or ``[M, r, P]`` streams."""
    rays_per_point, points = (1, e.shape[1]) if e.dim() == 2 else (e.shape[1], e.shape[2])
    return sequence_blocks(rays_per_point, points, block, point_order, e.device)


def dyn_offsets(
    e: torch.Tensor, u: torch.Tensor, height: int, width: int, window: int, block: int | None = None,
    point_order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block row-window origins and fit flags, each ``[M * nb]`` int32.

    The port of ``_dyn_offsets``: a block fits when every in-bounds deposit
    row lies in [ou, ou + window), i.e. max u <= ou + window - 2, with ou the
    8-aligned floor of the least valid u clamped into the bitmap. Validity is
    the in-bounds test, not w > 0. A block with no valid ray fits at 0. The
    blocks are those of the sequence of ``[M, N]`` or ``[M, r, P]`` streams
    (see the module's note).
    """
    _check_window(window, height)
    ids, blocks = _sequence_of(e, _ray_block(block), point_order)
    return _row_windows(e, u, height, width, window, ids, blocks)


def window_2d_offsets(
    e: torch.Tensor,
    u: torch.Tensor,
    height: int,
    width: int,
    window_u: int = WINDOW_2D[0],
    window_e: int = WINDOW_2D[1],
    block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block row and column window origins and fit flags of ``[M, N]`` rays, each
    ``[M * nb]`` int32: ``dyn2d_forward``'s offsets (rows 8-aligned, columns 128-aligned)."""
    _check_window_2d(window_u, window_e, height, width)
    ids, blocks = _sequence_of(e, _ray_block(block), None)
    min_u, max_u, min_e, max_e, any_valid = _extents(e, u, height, width, ids, blocks)
    ou = _origin(min_u, ROW_ALIGN, height - window_u)
    oe = _origin(min_e, COLUMN_ALIGN, width - window_e)
    fits = ~any_valid | (
        (max_u <= ou.to(max_u.dtype) + window_u - 2) & (max_e <= oe.to(max_e.dtype) + window_e - 2)
    )
    zero = torch.zeros_like(ou)
    ou, oe = torch.where(any_valid, ou, zero), torch.where(any_valid, oe, zero)
    return tuple(x.reshape(-1).to(torch.int32) for x in (ou, oe, fits))


# --------------------------------------------------------------------------- #
# Plain versions.
# --------------------------------------------------------------------------- #


class _BlockRays:
    """The rays ``[M, N]`` in the streams' own layout: cells, fractions, validity, and
    each valid ray's place in its block's window ``(ou, oe)`` (``ids``: its block)."""

    def __init__(self, e, u, w, height, width, ids, blocks, window_u, window_e, ou, oe, fits):
        e, u, self.w = _flat(e), _flat(u), _flat(w)
        num = e.shape[0]
        lower_e, lower_u = torch.floor(e), torch.floor(u)
        self.valid = _valid(lower_e, lower_u, height, width)
        zero = torch.zeros_like(e)
        self.fe = torch.where(self.valid, e - lower_e, zero)
        self.fu = torch.where(self.valid, u - lower_u, zero)
        row = torch.where(self.valid, lower_u, zero).long()
        col = torch.where(self.valid, lower_e, zero).long()
        slot = torch.arange(num, device=e.device)[:, None] * blocks + ids[None, :]
        self.fits = fits.bool()[slot]
        self.windowed = self.valid & self.fits
        local_row, local_col = row - ou.long()[slot], col - oe.long()[slot]
        inside = (local_row >= 0) & (local_row + 1 < window_u) & (local_col >= 0) & (local_col + 1 < window_e)
        if not bool((inside | ~self.windowed).all()):
            raise AssertionError("a deposit of a fitting block falls outside its window")
        # Lower-left tap: in the block's window slice, or in the heliostat's map.
        self.window_base = torch.where(self.windowed, (slot * window_u + local_row) * window_e + local_col, 0)
        heliostat = torch.arange(num, device=e.device)[:, None]
        self.map_base = torch.where(self.valid, (heliostat * height + row) * width + col, 0)


def _taps(base: torch.Tensor, stride: int) -> torch.Tensor:
    return torch.cat([base, base + 1, base + stride, base + stride + 1], dim=-1)


def _window_pixels(ou, oe, height, width, window_u, window_e, blocks) -> torch.Tensor:
    """Flat map index of every element of every block's window slice."""
    heliostat = torch.arange(ou.numel(), device=ou.device) // blocks
    rows = (heliostat * height + ou.long())[:, None, None] + torch.arange(window_u, device=ou.device)[None, :, None]
    cols = oe.long()[:, None, None] + torch.arange(window_e, device=ou.device)[None, None, :]
    return (rows * width + cols).reshape(-1)


def _window_forward_plain(
    e, u, w, height, width, block, window_u, window_e, ou, oe, fits, point_order=None
) -> torch.Tensor:
    """Each fitting block's taps into its own ``[window_u, window_e]`` slice at (ou, oe),
    placed into the map afterwards; the other blocks' taps into the map directly."""
    ids, blocks = _sequence_of(e, block, point_order)
    rays = _BlockRays(e, u, w, height, width, ids, blocks, window_u, window_e, ou, oe, fits)
    weight = torch.where(rays.valid, rays.w, torch.zeros_like(rays.w))
    fe, fu = rays.fe, rays.fu
    values = torch.cat(
        [weight * (1.0 - fu) * (1.0 - fe), weight * (1.0 - fu) * fe, weight * fu * (1.0 - fe), weight * fu * fe],
        dim=-1,
    )
    zero = torch.zeros_like(values)
    num = e.shape[0]
    slices = torch.zeros(ou.numel() * window_u * window_e, dtype=e.dtype, device=e.device)
    slices.index_add_(
        0, _taps(rays.window_base, window_e).reshape(-1), torch.where(rays.windowed.repeat(1, 4), values, zero).reshape(-1)
    )
    out = torch.zeros(num * height * width, dtype=e.dtype, device=e.device)
    spilled = rays.valid & ~rays.fits
    out.index_add_(0, _taps(rays.map_base, width).reshape(-1), torch.where(spilled.repeat(1, 4), values, zero).reshape(-1))
    out.index_add_(0, _window_pixels(ou, oe, height, width, window_u, window_e, blocks), slices)
    return out.reshape(num, height, width)


def splat_dynamic_window_forward_plain(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int, window: int,
    block: int | None = None, point_order: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the dynamic-window forward: per-block ``[window, W]`` slices at ``ou``."""
    block = _ray_block(block)
    ou, fits = dyn_offsets(e, u, height, width, window, block, point_order)
    return _window_forward_plain(e, u, w, height, width, block, window, width, ou, torch.zeros_like(ou), fits, point_order)


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
    window: int, block: int | None = None, point_order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the dynamic-window backward, ``_dyn_bwd``'s: a fitting block's rays
    gather their four taps from its ``[window, W]`` slice of ``g``, the others from ``g``."""
    block = _ray_block(block)
    ids, blocks = _sequence_of(e, block, point_order)
    ou, fits = _row_windows(e, u, height, width, window, ids, blocks)
    rays = _BlockRays(e, u, w, height, width, ids, blocks, window, width, ou, torch.zeros_like(ou), fits)
    flat = g.reshape(-1)
    slices = flat[_window_pixels(ou, torch.zeros_like(ou), height, width, window, width, blocks)]

    def tap(shift: int) -> torch.Tensor:
        return torch.where(rays.fits, slices[rays.window_base + shift], flat[rays.map_base + shift])

    g00, g01, g10, g11 = tap(0), tap(1), tap(width), tap(width + 1)
    fe, fu, weight = rays.fe, rays.fu, rays.w
    zero = torch.zeros_like(fe)
    dw = (1.0 - fu) * (1.0 - fe) * g00 + (1.0 - fu) * fe * g01 + fu * (1.0 - fe) * g10 + fu * fe * g11
    de = weight * ((1.0 - fu) * (g01 - g00) + fu * (g11 - g10))
    du = weight * ((1.0 - fe) * (g10 - g00) + fe * (g11 - g01))
    return tuple(torch.where(rays.valid, x, zero).reshape(e.shape) for x in (de, du, dw))


# --------------------------------------------------------------------------- #
# Kernel wrappers.
# --------------------------------------------------------------------------- #


def _check_launch(e, height: int, width: int, window_u: int, window_e: int | None) -> None:
    """What the kernels take besides the streams: CUDA tensors, a bitmap of 2 x 2 or more,
    a window inside it."""
    if not e.is_cuda:
        raise ValueError(f"the kernels take CUDA tensors, got {e.device}")
    _check_bitmap(height, width)
    if window_e is None:
        _check_window(window_u, height)
    else:
        _check_window_2d(window_u, window_e, height, width)


def window_band_rows(
    rays_per_map: int, height: int, width: int, shared_bytes: int, block: int | None = None, columns: bool = False
) -> int:
    """The window forward kernels' rows a band for ``[M, rays_per_map]`` rays onto
    ``[M, height, width]`` maps: :func:`artist_tpu_torch.kernels.splat.band_layout` of the
    per-block limit ``shared_bytes`` less two floats (four with ``columns``) for each ray
    block of a heliostat (a band's block keeps them for the ray blocks it plans). Raises if
    one row does not fit."""
    per_block = 16 if columns else 8
    return band_layout(height, width, shared_bytes - per_block * -(-rays_per_map // _ray_block(block)))


def _fitting_counts(num_maps: int, height: int, band_rows: int, device) -> torch.Tensor:
    """The band kernel's per-thread-block counts of fitting blocks, which it writes whole."""
    bands = -(-height // band_rows)
    return torch.empty(bands * min(num_maps, _MAX_GRID_Y), dtype=torch.int32, device=device)


def splat_dynamic_window_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int, window: int,
    block: int | None = None, point_order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``band_accumulate_kernel<kRowWindows>`` on the rays in place: ``[M, H, W]``
    bitmaps, and the number of blocks that fit their window as int32 partial counts (their
    ``sum()``). ``point_order`` may be int64; int32 saves a conversion on the card. It must
    be a permutation of ``range(P)``, which the plain version checks; the kernel reads no
    ray through an entry outside it (that point's rays leave the plan, not the bitmaps)."""
    rays_per_point, points = _layout(e, u, w, point_order)
    _check_launch(e, height, width, window, None)
    block = _ray_block(block)
    num, rays_per_map = e.shape[0], rays_per_point * points
    if num * rays_per_map == 0:
        return (torch.zeros((num, height, width), dtype=torch.float32, device=e.device),
                torch.zeros(1, dtype=torch.int32, device=e.device))
    order = None if point_order is None else point_order.to(torch.int32).contiguous()
    out = torch.empty((num, height, width), dtype=torch.float32, device=e.device)
    library = _load()
    band_rows = window_band_rows(rays_per_map, height, width, shared_limit(e.device), block)
    fitting = _fitting_counts(num, height, band_rows, e.device)
    status = library.splat_window_band_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), fitting.data_ptr(),
        num, rays_per_map, height, width, band_rows, block, window,
        None if order is None else order.data_ptr(), rays_per_point,
        e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "splat_dynamic_window_forward", status)
    LAUNCHES["splat_dynamic_window_forward"] += 1
    return out, fitting


def splat_window_2d_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int,
    window_u: int = WINDOW_2D[0], window_e: int = WINDOW_2D[1], block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``band_accumulate_kernel<kTileWindows>`` on ``[M, N]`` rays: bitmaps, and the
    number of fitting blocks as int32 partial counts (their ``sum()``)."""
    _check_rays(e, u, w)
    _check_launch(e, height, width, window_u, window_e)
    block = _ray_block(block)
    num, rays_per_map = e.shape
    if e.numel() == 0:
        return (torch.zeros((num, height, width), dtype=torch.float32, device=e.device),
                torch.zeros(1, dtype=torch.int32, device=e.device))
    out = torch.empty((num, height, width), dtype=torch.float32, device=e.device)
    library = _load()
    band_rows = window_band_rows(rays_per_map, height, width, shared_limit(e.device), block, columns=True)
    fitting = _fitting_counts(num, height, band_rows, e.device)
    status = library.splat_window_2d_band_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), fitting.data_ptr(),
        num, rays_per_map, height, width, band_rows, block, window_u, window_e,
        e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "splat_window_2d_forward", status)
    LAUNCHES["splat_window_2d_forward"] += 1
    return out, fitting


def splat_dynamic_window_backward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, g: torch.Tensor, height: int, width: int,
    window: int, block: int | None = None, point_order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``splat.cu``'s ``splat_backward_kernel`` on the rays in place: per-ray
    (de, du, dw) in the streams' shape. The window, the blocks and the order change no
    cotangent; they are checked as the forward checks them, and not read."""
    _layout(e, u, w, point_order)
    _check_launch(e, height, width, window, None)
    _ray_block(block)
    if g.shape != (e.shape[0], height, width) or g.device != e.device or g.dtype != e.dtype or not g.is_contiguous():
        raise ValueError(f"cotangent of shape {tuple(g.shape)} does not match the bitmaps")
    grads = _splat.backward_gather(e, u, w, g, height, width)
    if e.numel():
        LAUNCHES["splat_dynamic_window_backward"] += 1
    return grads


# --------------------------------------------------------------------------- #
# Entry points.
# --------------------------------------------------------------------------- #


class BilinearSplatDynamicWindow(torch.autograd.Function):
    """``[M, N]`` or ``[M, r, P]`` rays -> ``[M, H, W]`` flux through per-block row windows,
    with its VJP.

    CUDA tensors launch the kernels of ``csrc/splat_window.cu`` and ``csrc/splat.cu``;
    CPU tensors run the plain versions above.
    """

    @staticmethod
    def forward(ctx, e, u, w, height: int, width: int, window: int, block: int, point_order=None):
        with span("artist.kernels.splat_forward"):
            _layout(e, u, w, point_order)
            _check_bitmap(height, width)
            _check_window(window, height)
            ctx.save_for_backward(e, u, w)
            ctx.sizes = (height, width, window, block)
            ctx.point_order = point_order
            if e.is_cuda:
                return splat_dynamic_window_forward_cuda(e, u, w, height, width, window, block, point_order)[0]
            return splat_dynamic_window_forward_plain(e, u, w, height, width, window, block, point_order)

    @staticmethod
    def backward(ctx, g):
        # Unpacked before the span, as in BilinearSplat.backward.
        e, u, w = ctx.saved_tensors
        with span("artist.kernels.splat_backward"):
            height, width, window, block = ctx.sizes
            g = g.contiguous()
            if g.shape != (e.shape[0], height, width) or g.device != e.device or g.dtype != e.dtype:
                raise ValueError(f"cotangent of shape {tuple(g.shape)} does not match the bitmaps")
            if e.is_cuda:
                grads = splat_dynamic_window_backward_cuda(e, u, w, g, height, width, window, block, ctx.point_order)
            else:
                grads = splat_dynamic_window_backward_plain(
                    e, u, w, g, height, width, window, block, ctx.point_order
                )
            return (*grads, None, None, None, None, None)


def splat_dynamic_window(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
    window: int = 96,
    block: int | None = None,
    point_order: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact bilinear splat with per-ray-block row windows, ``[M, N]`` or ``[M, r, P]`` rays
    -> ``[M, height_u, width_e]``. ``bitmap_resolution`` is (width_e, height_u); ``block``
    defaults to ``RAY_BLOCK``. No flip. The blocks are cut from the point-major sequence
    of the streams through ``point_order`` (see the module's note); spatially tiled
    surface points (:func:`artist_tpu_torch.raytracing.splatting.point_tile_order`) give
    compact blocks, most of which fit the window."""
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    return BilinearSplatDynamicWindow.apply(
        bitmap_e, bitmap_u, intensities, height, width, int(window), _ray_block(block), point_order
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
        return out, fitting.sum().float() / max(blocks, 1)
    ou, oe, fits = window_2d_offsets(bitmap_e, bitmap_u, height, width, window_u, window_e, block)
    out = _window_forward_plain(
        bitmap_e, bitmap_u, intensities, height, width, block, window_u, window_e, ou, oe, fits
    )
    return out, fits.float().mean()

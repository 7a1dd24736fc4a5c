"""Per-ray accumulate of the bilinear splat into a map held on chip, band by band.

Counterpart of ``scatter_forward`` in ``tools/splat_formulation_bench.py``,
the "literal per-ray VMEM accumulate" prototype. Its kernel lives in
``csrc/splat_scatter.cu``: ``splat_cluster_forward`` replaces
``_scatter_kernel`` with ``band_accumulate_kernel``. A heliostat's map is cut
into bands of rows and its rays into shares (:func:`band_layout`); one thread
block per (band, share, heliostat) holds its band in shared memory, reads
every ray of its share and adds with shared-memory atomics only the taps that
land in its rows, then adds the rows it touched to the map in device memory.
No tap leaves the block's own SM. Forward only, as in the tool.

:func:`splat_cluster_forward` dispatches on the tensors' device: a CUDA
tensor launches the kernel or raises; a CPU tensor runs the plain version,
the 4-tap scatter :func:`artist_tpu_torch.kernels.splat.splat_forward_plain`,
which computes the same function. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from artist_tpu_torch.kernels.build import load_library
from artist_tpu_torch.kernels.splat import _check_bitmap, _check_rays, splat_forward_plain

LAUNCHES = {"splat_cluster_forward": 0}
# Two of the kernel's 1024-thread blocks share an SM when each band takes at
# most half an SM's shared memory (the per-block opt-in limit is the SM's less
# the 1 KB the card reserves for each block).
BLOCKS_PER_SM = 2
RESERVED_BYTES = 1024
# Rays of one heliostat that a (band, share) block reads: enough that zeroing
# and flushing its band is small next to its taps, few enough that the grid
# has several waves of blocks to balance bands of unequal work.
RAYS_PER_SHARE = 32_000

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("splat_scatter")
        pointer, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        # e, u, w, out; M, N, H, W; rows a band, rays a share; device, stream.
        library.splat_scatter_forward.argtypes = [pointer] * 4 + [i64, i64, i32, i32, i32, i64, i32, pointer]
        library.splat_scatter_shared_limit.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        for name in ("splat_scatter_forward", "splat_scatter_shared_limit"):
            getattr(library, name).restype = ctypes.c_int
        library.splat_scatter_error_string.argtypes = [ctypes.c_int]
        library.splat_scatter_error_string.restype = ctypes.c_char_p
        _library = library
    return _library


def _check_status(library: ctypes.CDLL, name: str, status: int) -> None:
    if status != 0:
        message = library.splat_scatter_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} ({status})")


def band_layout(height: int, width: int, rays: int, shared_bytes: int) -> tuple[int, int]:
    """The kernel's launch shape for ``[M, rays]`` rays onto ``[M, height, width]`` fp32 maps:
    ``(rows a band, rays a share)``.

    Bands are as equal as the fewest bands of at most half an SM's shared
    memory allow (``shared_bytes`` is the per-block opt-in limit), and never
    less than one row; shares as equal as ``RAYS_PER_SHARE`` rays each allow.
    Raises if one row does not fit ``shared_bytes``.
    """
    row_bytes = 4 * width
    if row_bytes > shared_bytes:
        raise ValueError(f"a row of {width} fp32 pixels does not fit {shared_bytes} bytes of shared memory")
    budget = max(shared_bytes // BLOCKS_PER_SM - RESERVED_BYTES, row_bytes)
    bands = -(-height // (budget // row_bytes))
    shares = max(1, -(-rays // RAYS_PER_SHARE))
    return -(-height // bands), max(1, -(-rays // shares))


def splat_cluster_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Launch ``band_accumulate_kernel``: ``[M, N]`` rays -> ``[M, H, W]`` bitmaps."""
    _check_rays(e, u, w)
    _check_bitmap(height, width)
    if not e.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {e.device}")
    out = torch.zeros((e.shape[0], height, width), dtype=torch.float32, device=e.device)
    if e.numel() == 0:
        return out
    library = _load()
    limit = ctypes.c_int(0)
    _check_status(library, "splat_scatter_shared_limit", library.splat_scatter_shared_limit(e.device.index, limit))
    band_rows, rays_per_share = band_layout(height, width, e.shape[1], limit.value)
    status = library.splat_scatter_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), e.shape[0], e.shape[1], height, width,
        band_rows, rays_per_share, e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
    )
    _check_status(library, "splat_cluster_forward", status)
    LAUNCHES["splat_cluster_forward"] += 1
    return out


def splat_cluster_forward(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
) -> torch.Tensor:
    """The splat forward by per-ray accumulation (no gradient): ``[M, N]`` rays ->
    ``[M, height_u, width_e]``. ``bitmap_resolution`` is (width_e, height_u). No flip."""
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    if bitmap_e.is_cuda:
        return splat_cluster_forward_cuda(bitmap_e, bitmap_u, intensities, height, width)
    _check_rays(bitmap_e, bitmap_u, intensities)
    _check_bitmap(height, width)
    return splat_forward_plain(bitmap_e, bitmap_u, intensities, height, width)

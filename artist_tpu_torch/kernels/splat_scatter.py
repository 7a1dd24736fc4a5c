"""Per-ray accumulate of the bilinear splat in a thread-block cluster's shared memory.

Counterpart of ``scatter_forward`` in ``tools/splat_formulation_bench.py``,
the "literal per-ray VMEM accumulate" prototype. Its kernel lives in
``csrc/splat_scatter.cu``: ``splat_cluster_forward`` replaces
``_scatter_kernel``. A heliostat's whole map is held on chip, split by rows
over the blocks of a cluster (:func:`cluster_size` of them; two at 256 x 256
fp32), each ray adds its four taps with shared-memory atomics into the
owning block's rows, and each block then adds its rows to the map in device
memory. Forward only, as in the tool.

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
# The portable limit of blocks in a cluster.
MAX_CLUSTER = 8
# The kernel's blocks are 1024 threads; each cluster takes about this many
# rays per thread of its blocks, so the zeroing and flushing of its share of
# the map spreads over enough rays.
KERNEL_THREADS = 1024
RAYS_PER_THREAD = 16

_library: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _library
    if _library is None:
        library = load_library("splat_scatter")
        pointer, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        # e, u, w, out; M, N, H, W; cluster size, clusters per map; device, stream.
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


def cluster_size(height: int, width: int, shared_bytes: int) -> int:
    """The fewest blocks, at most ``MAX_CLUSTER``, whose ``shared_bytes`` each hold an
    fp32 ``[height, width]`` map split by rows; raises if no such cluster exists."""
    for size in range(1, MAX_CLUSTER + 1):
        if 4 * -(-height // size) * width <= shared_bytes:
            return size
    raise ValueError(
        f"a {height} x {width} fp32 map does not fit the shared memory of {MAX_CLUSTER} blocks "
        f"({shared_bytes} bytes each)"
    )


def splat_cluster_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Launch ``cluster_accumulate_kernel``: ``[M, N]`` rays -> ``[M, H, W]`` bitmaps."""
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
    cluster = cluster_size(height, width, limit.value)
    clusters_per_map = max(1, -(-e.shape[1] // (cluster * KERNEL_THREADS * RAYS_PER_THREAD)))
    status = library.splat_scatter_forward(
        e.data_ptr(), u.data_ptr(), w.data_ptr(), out.data_ptr(), e.shape[0], e.shape[1], height, width,
        cluster, clusters_per_map, e.device.index, torch.cuda.current_stream(e.device).cuda_stream,
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

"""Per-ray accumulate of the bilinear splat into a map held on chip, band by band.

Counterpart of ``scatter_forward`` in ``tools/splat_formulation_bench.py``,
the "literal per-ray VMEM accumulate" prototype. ``splat_band_forward``
replaces ``_scatter_kernel`` with ``band_accumulate_kernel`` of
``csrc/splat.cu``, the kernel of the full splat's forward
(:func:`artist_tpu_torch.kernels.splat.band_forward`): a heliostat's map is
cut into as few bands of rows as fit one thread block's shared memory
(:func:`artist_tpu_torch.kernels.splat.band_layout`); one block per (band,
heliostat) holds its band in shared memory, reads every ray of the heliostat,
adds with shared-memory atomics only the taps that land in its rows, and
stores the band whole into the map, whose pixels no other block writes. No tap
leaves the block's own SM. Forward only, as in the tool.

:func:`splat_band_forward` dispatches on the tensors' device: a CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version, the 4-tap
scatter :func:`artist_tpu_torch.kernels.splat.splat_forward_plain`, which
computes the same function. ``LAUNCHES`` counts this wrapper's launches.
"""

from __future__ import annotations

import torch

from artist_tpu_torch.kernels.splat import _check_bitmap, _check_rays, band_forward, splat_forward_plain

LAUNCHES = {"splat_band_forward": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def splat_band_forward_cuda(
    e: torch.Tensor, u: torch.Tensor, w: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Launch ``band_accumulate_kernel``: ``[M, N]`` rays -> ``[M, H, W]`` bitmaps."""
    _check_rays(e, u, w)
    _check_bitmap(height, width)
    if not e.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {e.device}")
    out = band_forward(e, u, w, height, width)
    if e.numel():
        LAUNCHES["splat_band_forward"] += 1
    return out


def splat_band_forward(
    bitmap_e: torch.Tensor,
    bitmap_u: torch.Tensor,
    intensities: torch.Tensor,
    bitmap_resolution: tuple[int, int],
) -> torch.Tensor:
    """The splat forward by per-ray accumulation (no gradient): ``[M, N]`` rays ->
    ``[M, height_u, width_e]``. ``bitmap_resolution`` is (width_e, height_u). No flip."""
    width, height = int(bitmap_resolution[0]), int(bitmap_resolution[1])
    if bitmap_e.is_cuda:
        return splat_band_forward_cuda(bitmap_e, bitmap_u, intensities, height, width)
    _check_rays(bitmap_e, bitmap_u, intensities)
    _check_bitmap(height, width)
    return splat_forward_plain(bitmap_e, bitmap_u, intensities, height, width)

"""Losses of the inverse problems (counterpart of ``artist_tpu/optim/losses.py``).

Pure functions; each loss returns a per-sample vector ``[M]``, and the
reductions take it to one value per heliostat.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.flux.bitmap import get_center_of_mass
from artist_tpu_torch.geometry.coordinates import bitmap_coordinates_to_target_coordinates
from artist_tpu_torch.geometry.transforms import _normalize


def vector_loss(
    prediction: torch.Tensor,
    ground_truth: torch.Tensor,
    reduction_dimensions: tuple[int, ...] = (1,),
) -> torch.Tensor:
    """Squared error summed over ``reduction_dimensions``."""
    return torch.sum((prediction - ground_truth) ** 2, dim=reduction_dimensions)


def pixel_loss(prediction: torch.Tensor, ground_truth: torch.Tensor) -> torch.Tensor:
    """Pixel-wise squared error normalized by the total ground-truth intensity."""
    per_pixel = (prediction - ground_truth) ** 2
    return torch.sum(per_pixel, dim=(1, 2)) / torch.sum(ground_truth, dim=(1, 2))


def kl_divergence_loss(
    prediction: torch.Tensor, ground_truth: torch.Tensor
) -> torch.Tensor:
    """KL divergence D(P || Q) of the L1-normalized flux distributions.

    P is the ground truth and Q the prediction, each ``[M, H, W]``:
    ``sum P (log P - log Q)`` with ``1e-12`` guards.
    """
    eps = 1e-12

    def l1_normalize(x: torch.Tensor) -> torch.Tensor:
        norm = torch.sum(torch.abs(x), dim=(1, 2), keepdim=True)
        return x / torch.clamp(norm, min=eps)

    p = l1_normalize(ground_truth)
    q = l1_normalize(prediction)
    return torch.sum(p * (torch.log(p + eps) - torch.log(q + eps)), dim=(1, 2))


def focal_spot_loss(
    prediction_bitmaps: torch.Tensor,
    ground_truth: torch.Tensor,
    tower: SolarTower,
    target_area_indices: torch.Tensor,
    bitmap_resolution: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Distance between the predicted and the measured focal spots in the world.

    The centre of mass of each predicted bitmap ``[M, H, W]`` is mapped onto
    its target area (planar or cylindrical). ``ground_truth`` is either the
    measured bitmaps ``[M, H, W]``, whose centres are mapped the same way, or
    the measured focal spots in world coordinates ``[M, 4]``.
    ``bitmap_resolution`` is (width, height), by default the bitmaps'.
    """
    if bitmap_resolution is None:
        bitmap_resolution = (prediction_bitmaps.shape[2], prediction_bitmaps.shape[1])
    predicted = bitmap_coordinates_to_target_coordinates(
        get_center_of_mass(prediction_bitmaps), bitmap_resolution, tower, target_area_indices
    )
    if ground_truth.ndim == 3:
        measured = bitmap_coordinates_to_target_coordinates(
            get_center_of_mass(ground_truth), bitmap_resolution, tower, target_area_indices
        )
    else:
        measured = ground_truth
    return torch.linalg.vector_norm(predicted[:, :3] - measured[:, :3], dim=1)


class _ClipToUnit(torch.autograd.Function):
    """``clamp(x, -1, 1)`` whose backward multiplies the cotangent by 1 inside
    the interval, 1/2 on its ends and 0 outside, as ``jnp.clip`` does: an
    infinite cotangent outside the interval becomes NaN, not 0 (``torch.clamp``
    selects instead of multiplying, and passes 1 on the ends)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.clamp(x, -1.0, 1.0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        inside = (x.abs() < 1.0).to(grad.dtype) + 0.5 * (x.abs() == 1.0).to(grad.dtype)
        return grad * inside


def angle_loss(prediction: torch.Tensor, ground_truth: torch.Tensor) -> torch.Tensor:
    """Angle between the predicted and the measured directions ``[M, >=3]``:
    ``arccos`` of the clipped dot product of their normalized first three
    components. Its derivative is infinite where the two agree in fp32; the
    kinematics reconstructor scrubs such gradients."""
    p = _normalize(prediction[:, :3])
    g = _normalize(ground_truth[:, :3])
    return torch.arccos(_ClipToUnit.apply(torch.sum(p * g, dim=-1)))


def cosine_similarity_loss(
    prediction: torch.Tensor, ground_truth: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """``1 - cos`` of the angle between the vectors along the last axis."""
    dot = torch.sum(prediction * ground_truth, dim=-1)
    norms = torch.linalg.vector_norm(prediction, dim=-1) * torch.linalg.vector_norm(ground_truth, dim=-1)
    return 1.0 - dot / torch.maximum(norms, torch.full_like(norms, eps))


def reduce_loss_per_sample(
    loss_per_sample: torch.Tensor,
    number_of_samples_per_heliostat: int,
    reduction: Callable[[torch.Tensor], torch.Tensor] | str = "mean",
) -> torch.Tensor:
    """Sample -> heliostat loss reduction for one uniform sample count.

    ``"mean"``, ``"median"`` (the lower of the two middle elements, as
    ``torch.median``) or a function of the ``[H, count]`` losses. Samples
    past the last whole heliostat are dropped. For
    per-heliostat counts that differ use :func:`reduce_loss_per_heliostat`.
    """
    number_of_heliostats = loss_per_sample.numel() // number_of_samples_per_heliostat
    grouped = loss_per_sample[: number_of_heliostats * number_of_samples_per_heliostat].reshape(
        number_of_heliostats, number_of_samples_per_heliostat
    )
    if reduction == "mean":
        return torch.mean(grouped, dim=1)
    if reduction == "median":
        sorted_losses = torch.sort(grouped, dim=1).values
        return sorted_losses[:, (number_of_samples_per_heliostat - 1) // 2]
    return reduction(grouped)


def build_sample_index_matrix(sample_counts) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: pad ragged per-heliostat sample blocks to a gather matrix.

    Heliostat ``h`` owns the samples ``[start_h, start_h + counts[h])``.
    Returns ``padded_indices`` int32 ``[H, max_count]`` (0 past each
    heliostat's count) and ``valid`` bool ``[H, max_count]``; a heliostat
    with no sample keeps its row (its reduced loss is 0), and ``max_count``
    is at least 1.
    """
    counts = np.asarray(sample_counts, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    max_count = max(1, int(counts.max()) if counts.size else 1)
    offsets = np.arange(max_count)[None, :]
    valid = offsets < counts[:, None]
    padded = np.where(valid, starts[:, None] + offsets, 0).astype(np.int32)
    return padded, valid


def reduce_loss_per_heliostat(
    loss_per_sample: torch.Tensor,
    padded_sample_indices: torch.Tensor,
    sample_valid: torch.Tensor,
    reduction: str = "mean",
) -> torch.Tensor:
    """Sample -> heliostat loss reduction for ragged per-heliostat counts.

    Parameters
    ----------
    loss_per_sample : torch.Tensor
        ``[S]``.
    padded_sample_indices : torch.Tensor
        Integer ``[H, max_count]`` gather matrix (:func:`build_sample_index_matrix`).
    sample_valid : torch.Tensor
        Bool ``[H, max_count]``; False marks padding.
    reduction : str
        ``"mean"``, or ``"median"``: the lower middle element, with the
        padding sorted to +inf.

    Returns
    -------
    torch.Tensor
        ``[H]``; 0 for a heliostat with no sample.
    """
    grouped = loss_per_sample[padded_sample_indices.long()]
    counts = torch.sum(sample_valid, dim=1)
    if reduction == "mean":
        total = torch.sum(torch.where(sample_valid, grouped, torch.zeros_like(grouped)), dim=1)
        return total / torch.clamp(counts, min=1)
    if reduction == "median":
        padded = torch.where(sample_valid, grouped, torch.full_like(grouped, float("inf")))
        sorted_losses = torch.sort(padded, dim=1).values
        middle = torch.clamp((counts - 1) // 2, min=0)
        picked = torch.gather(sorted_losses, 1, middle[:, None])[:, 0]
        return torch.where(counts > 0, picked, torch.zeros_like(picked))
    raise ValueError(f"Unknown reduction: {reduction}")

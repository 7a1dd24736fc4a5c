"""Losses of the inverse problems (counterpart of ``artist_tpu/optim/losses.py``).

Pure functions; each returns a per-sample loss vector ``[M]``. Only the
losses of the surface-reconstruction step are ported so far.
"""

from __future__ import annotations

import torch


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

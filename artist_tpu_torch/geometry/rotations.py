"""Axis-angle rotation decomposition (counterpart of ``artist_tpu/geometry/rotations.py``)."""

from __future__ import annotations

import torch

from artist_tpu_torch.geometry.transforms import _normalize


def decompose_rotations(
    initial_vectors: torch.Tensor, target_vector: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ENU components of the axis-angle vector rotating initial -> target.

    Parameters
    ----------
    initial_vectors : torch.Tensor
        Homogeneous initial vectors ``[N, 4]`` (first 3 components used).
    target_vector : torch.Tensor
        Homogeneous target vector ``[4]``.

    Returns
    -------
    tuple of torch.Tensor
        (east, north, up) components of ``theta * axis``, each ``[N]``.
    """
    v0 = _normalize(initial_vectors[:, :3])
    t = _normalize(target_vector[:3])
    axis = torch.linalg.cross(v0, t.expand_as(v0), dim=-1)
    axis_normalized = _normalize(axis)
    theta = torch.arccos(torch.clamp(v0 @ t, -1.0, 1.0))[:, None]
    components = theta * axis_normalized
    return components[:, 0], components[:, 1], components[:, 2]

"""Axis-angle rotation helpers (counterpart of ``artist_tpu/geometry/rotations.py``)."""

from __future__ import annotations

import numpy as np
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


def rotation_angle_and_axis(
    from_orientation: np.ndarray, to_orientation: np.ndarray
) -> tuple[np.ndarray, float]:
    """Unit rotation axis and angle taking one orientation to another.

    Host numpy in float64: scenario loading calls it once (the actuators'
    initial-angle compensation). Parallel orientations give the axis e and
    angle 0; antiparallel ones an axis orthogonal to ``from_orientation``
    (built from e or n, whichever is further from it) and angle pi.

    Parameters
    ----------
    from_orientation, to_orientation : np.ndarray
        Homogeneous directions ``[4]`` (the first 3 components are used).
    """
    f = np.asarray(from_orientation, dtype=np.float64)[:3]
    t = np.asarray(to_orientation, dtype=np.float64)[:3]
    f = f / np.linalg.norm(f)
    t = t / np.linalg.norm(t)
    dot = float(np.clip(np.dot(f, t), -1.0, 1.0))
    angle = float(np.arccos(dot))
    axis = np.cross(f, t)
    axis_norm = float(np.linalg.norm(axis))
    epsilon = 1e-6
    if axis_norm < epsilon and dot > 0:
        return np.array([1.0, 0.0, 0.0]), 0.0
    if axis_norm < epsilon and dot < 0:
        if abs(f[0]) < abs(f[1]):
            orthogonal = np.array([1.0, 0.0, 0.0])
        else:
            orthogonal = np.array([0.0, 1.0, 0.0])
        axis = np.cross(f, orthogonal)
        return axis / np.linalg.norm(axis), float(np.pi)
    return axis / axis_norm, angle

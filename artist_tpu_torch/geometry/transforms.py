"""Batched 4x4 homogeneous ENU transforms.

Right-handed east-north-up coordinate system; positive angles rotate
counter-clockwise; points multiply as column vectors from the right.

Counterpart of ``artist_tpu/geometry/transforms.py``. For the hot
distortion-scatter path, :func:`apply_distortion_rotation` applies the
combined up-then-east rotation directly to direction components and never
builds the ``[..., 4, 4]`` rotation tensor. Geometry matmuls run in full
fp32: callers on the card keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

import torch

from artist_tpu_torch.util import indices


def _assemble(rows: list[list[torch.Tensor]]) -> torch.Tensor:
    """Stack a 4x4 list-of-lists of equally shaped tensors into [..., 4, 4]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_e(e: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about the east axis, ``[...] -> [..., 4, 4]``."""
    c, s = torch.cos(e), torch.sin(e)
    one, zero = torch.ones_like(e), torch.zeros_like(e)
    return _assemble(
        [
            [one, zero, zero, zero],
            [zero, c, -s, zero],
            [zero, s, c, zero],
            [zero, zero, zero, one],
        ]
    )


def rotate_n(n: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about the north axis, ``[...] -> [..., 4, 4]``."""
    c, s = torch.cos(n), torch.sin(n)
    one, zero = torch.ones_like(n), torch.zeros_like(n)
    return _assemble(
        [
            [c, zero, -s, zero],
            [zero, one, zero, zero],
            [s, zero, c, zero],
            [zero, zero, zero, one],
        ]
    )


def rotate_u(u: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about the up axis, ``[...] -> [..., 4, 4]``."""
    c, s = torch.cos(u), torch.sin(u)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    return _assemble(
        [
            [c, -s, zero, zero],
            [s, c, zero, zero],
            [zero, zero, one, zero],
            [zero, zero, zero, one],
        ]
    )


def translate_enu(e: torch.Tensor, n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Translation matrices for east/north/up offsets, ``[...] -> [..., 4, 4]``."""
    one, zero = torch.ones_like(e), torch.zeros_like(e)
    return _assemble(
        [
            [one, zero, zero, e],
            [zero, one, zero, n],
            [zero, zero, one, u],
            [zero, zero, zero, one],
        ]
    )


def rotate_distortions(e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The combined up-then-east rotation matrices of sun distortions, ``rotate_e(e) @
    rotate_u(u)``, ``[...] -> [..., 4, 4]``. The render applies them with
    :func:`apply_distortion_rotation`, which builds no matrix."""
    cos_e, sin_e = torch.cos(e), torch.sin(e)
    cos_u, sin_u = torch.cos(u), torch.sin(u)
    one, zero = torch.ones_like(e), torch.zeros_like(e)
    return _assemble(
        [
            [cos_u, -sin_u, zero, zero],
            [cos_e * sin_u, cos_e * cos_u, -sin_e, zero],
            [sin_e * sin_u, sin_e * cos_u, cos_e, zero],
            [zero, zero, zero, one],
        ]
    )


def apply_distortion_rotation(
    e: torch.Tensor, u: torch.Tensor, directions: torch.Tensor
) -> torch.Tensor:
    """Rotate direction vectors by the up-then-east distortion rotation, fused.

    Equals ``rotate_e(e) @ rotate_u(u) @ d`` for directions with a zero
    homogeneous component, computed component-wise so no ``[..., 4, 4]``
    tensor is built.

    Parameters
    ----------
    e, u : torch.Tensor
        Distortion angles in radians, broadcastable to the leading shape of
        ``directions``.
    directions : torch.Tensor
        Direction vectors ``[..., 3]`` or ``[..., 4]`` (the homogeneous
        component passes through untouched).

    Returns
    -------
    torch.Tensor
        Rotated directions, broadcast shape.
    """
    cos_e, sin_e = torch.cos(e), torch.sin(e)
    cos_u, sin_u = torch.cos(u), torch.sin(u)
    de = directions[..., indices.e]
    dn = directions[..., indices.n]
    du = directions[..., indices.u]
    out_e = cos_u * de - sin_u * dn
    out_n = cos_e * sin_u * de + cos_e * cos_u * dn - sin_e * du
    out_u = sin_e * sin_u * de + sin_e * cos_u * dn + cos_e * du
    components = [out_e, out_n, out_u]
    if directions.shape[-1] == 4:
        components.append(directions[..., 3])
    return torch.stack(torch.broadcast_tensors(*components), dim=-1)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis: ``v / max(||v||, eps)``.

    The semantics of ``torch.nn.functional.normalize``, written out so the
    ``eps`` matches the JAX package's ``_normalize`` call for call.
    """
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def canting_rotation_matrices(canting: torch.Tensor) -> torch.Tensor:
    """Orthonormal facet bases from canting vectors, ``[..., 2, 4] -> [..., 4, 4]``.

    Normalize e; u = normalize(e x n); n' = normalize(u x e); the columns of
    the rotation are [e, n', u].
    """
    e_vec = _normalize(canting[..., indices.e, :3])
    n_candidate = canting[..., indices.n, :3]
    u_vec = _normalize(torch.linalg.cross(e_vec, n_candidate, dim=-1), eps=1e-8)
    n_vec = _normalize(torch.linalg.cross(u_vec, e_vec, dim=-1), eps=1e-8)

    rot3 = torch.stack([e_vec, n_vec, u_vec], dim=-1)  # columns
    zeros_col = torch.zeros(rot3.shape[:-1] + (1,), dtype=rot3.dtype, device=rot3.device)
    top = torch.cat([rot3, zeros_col], dim=-1)  # [..., 3, 4]
    bottom = torch.zeros(rot3.shape[:-2] + (1, 4), dtype=rot3.dtype, device=rot3.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def perform_canting(
    canting: torch.Tensor, data: torch.Tensor, inverse: bool = False
) -> torch.Tensor:
    """Cant (rotate) surface points or normals into their facet frame.

    Data are row vectors ``[S, F, P, 4]``; forward canting multiplies by the
    transposed basis, decanting by the basis itself.

    Parameters
    ----------
    canting : torch.Tensor
        Canting vectors ``[S, F, 2, 4]``.
    data : torch.Tensor
        Points or normals ``[S, F, P, 4]``.
    inverse : bool
        False = cant, True = decant.
    """
    rotation = canting_rotation_matrices(canting)  # [S, F, 4, 4]
    if inverse:
        return torch.matmul(data, rotation)
    return torch.matmul(data, rotation.transpose(-1, -2))

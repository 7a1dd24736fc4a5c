"""Rays, receiver hits, flux maps and the losses on them, in plain PyTorch.

A ray leaves each surface point in the mirror direction of the sun's incident
direction, turned by the sun's scatter angles (about u, then about e); it hits
the receiver plane from the front or is lost; its power is the Lambert cosine
times the mirror reflectivity; it deposits bilinearly into the four pixels
around its hit, and a hit whose four pixels are not all inside is dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.geometry import unit

MIRROR_REFLECTIVITY = 0.935


def sun_distortions(generator: torch.Generator, samples: int, rays: int, points: int, covariance: float,
                    mean: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter angles (u, e) ``[samples, rays, points]`` of a normal sun, drawn in one call."""
    draw = torch.randn((samples, rays, points, 2), generator=generator, device=generator.device)
    draw = mean + covariance**0.5 * draw
    return draw[..., 0], draw[..., 1]


def receiver_hits(points, normals, incident, scatter_u, scatter_e, receiver, resolution):
    """Continuous pixel coordinates (e flipped, as seen from the field) and powers
    ``[M, R, P]`` of the rays of surfaces ``[M, P, 4]`` under incident directions
    ``[M, 4]``; lost rays have power 0 and lie outside the map."""
    width, height = resolution
    d = incident[:, None, :3]
    n = normals[..., :3]
    mirror = d - 2.0 * (d * n).sum(dim=-1, keepdim=True) * n  # [M, P, 3]
    x, y, z = (mirror[..., k][:, None, :] for k in range(3))
    cu, su = torch.cos(scatter_u), torch.sin(scatter_u)
    ce, se = torch.cos(scatter_e), torch.sin(scatter_e)
    x1, y1 = cu * x - su * y, su * x + cu * y  # about u
    direction = (x1, ce * y1 - se * z, se * y1 + ce * z)  # then about e
    center, plane_normal, size = receiver["center"], receiver["normal"], receiver["size"]
    cosine = sum(direction[k] * plane_normal[k] for k in range(3))
    front = cosine < 0.0
    origin = points[..., :3][:, None]
    reach = sum((center[k] - origin[..., k]) * plane_normal[k] for k in range(3))
    distance = reach / torch.where(front, cosine, torch.ones_like(cosine))
    hit_e = origin[..., 0] + direction[0] * distance
    hit_u = origin[..., 2] + direction[2] * distance
    pixel_e = (hit_e + size[0] / 2 - center[0]) / size[0] * (width - 1)
    pixel_u = (hit_u + size[1] / 2 - center[2]) / size[1] * (height - 1)
    inside = front & (pixel_e >= 0) & (pixel_e <= width - 1) & (pixel_u >= 0) & (pixel_u <= height - 1)
    power = torch.where(inside, -cosine * MIRROR_REFLECTIVITY, torch.zeros_like(cosine))
    pixel_e = torch.where(inside, (width - 1) - pixel_e, torch.full_like(pixel_e, -1.0))
    pixel_u = torch.where(inside, pixel_u, torch.full_like(pixel_u, -1.0))
    return pixel_e, pixel_u, power


def splat(pixel_e, pixel_u, power, resolution) -> torch.Tensor:
    """Flux maps ``[M, H, W]`` (row 0 at the top) of rays ``[M, ...]``."""
    width, height = resolution
    maps = power.shape[0]
    e, u, w = (t.reshape(maps, -1) for t in (pixel_e, pixel_u, power))
    col, row = torch.floor(e), torch.floor(u)
    keep = (col >= 0) & (col <= width - 2) & (row >= 0) & (row <= height - 2)
    fe, fu = e - col, u - row
    w = torch.where(keep, w, torch.zeros_like(w))
    base = torch.where(keep, row * width + col, torch.zeros_like(col)).long()
    base = base + torch.arange(maps, device=e.device)[:, None] * (width * height)
    index = torch.cat([base, base + 1, base + width, base + width + 1], dim=1).reshape(-1)
    values = torch.cat([w * (1 - fe) * (1 - fu), w * fe * (1 - fu), w * (1 - fe) * fu, w * fe * fu], dim=1)
    flux = torch.zeros(maps * height * width, device=e.device).index_add(0, index, values.reshape(-1))
    return torch.flip(flux.reshape(maps, height, width), dims=(1,))


def trace(points, normals, incident, scatter_u, scatter_e, receiver, resolution) -> torch.Tensor:
    return splat(*receiver_hits(points, normals, incident, scatter_u, scatter_e, receiver, resolution), resolution)


def centers_of_mass(flux: torch.Tensor) -> torch.Tensor:
    """(e, u) pixel centres of mass ``[M, 2]`` of maps ``[M, H, W]``."""
    _, height, width = flux.shape
    share = flux / (flux.sum(dim=(1, 2), keepdim=True) + 1e-8)
    e = (share.sum(dim=1) * torch.arange(width, dtype=flux.dtype, device=flux.device)).sum(dim=1)
    u = (share.sum(dim=2) * torch.arange(height, dtype=flux.dtype, device=flux.device)).sum(dim=1)
    return torch.stack([e, u], dim=1)


def receiver_points(pixels: torch.Tensor, receiver, resolution) -> torch.Tensor:
    """World points ``[M, 3]`` of pixel coordinates ``[M, 2]`` (cell centres; e as seen from the field)."""
    width, height = resolution
    e = (pixels[:, 0] + 0.5) / width
    u = (pixels[:, 1] + 0.5) / height
    center, size = receiver["center"], receiver["size"]
    return torch.stack(
        [center[0] + (0.5 - e) * size[0], center[1] + torch.zeros_like(e), center[2] + (0.5 - u) * size[1]], dim=1
    )


def crop_around_center(flux: torch.Tensor, receiver, crop: float = 6.0) -> torch.Tensor:
    """Each map resampled over a ``crop`` x ``crop`` m window centred on its centre of
    mass, at its own resolution (bilinear, zero outside the map)."""
    maps, height, width = flux.shape
    share = flux / (flux.sum(dim=(1, 2), keepdim=True) + 1e-8)
    x = torch.linspace(-1.0, 1.0, width, device=flux.device)
    y = torch.linspace(-1.0, 1.0, height, device=flux.device)
    x_center = (share.sum(dim=1) * x).sum(dim=1)
    y_center = (share.sum(dim=2) * y).sum(dim=1)
    grid_x = crop / receiver["size"][0] * x[None, :] + x_center[:, None]  # [M, W]
    grid_y = crop / receiver["size"][1] * y[None, :] + y_center[:, None]  # [M, H]
    grid = torch.stack(torch.broadcast_tensors(grid_x[:, None, :], grid_y[:, :, None]), dim=-1)
    return F.grid_sample(flux[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)[:, 0]


def kl_divergence(prediction: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """KL(truth || prediction) of the L1-normalized maps, per map."""
    eps = 1e-12
    p = truth / torch.clamp(truth.abs().sum(dim=(1, 2), keepdim=True), min=eps)
    q = prediction / torch.clamp(prediction.abs().sum(dim=(1, 2), keepdim=True), min=eps)
    return (p * (torch.log(p + eps) - torch.log(q + eps))).sum(dim=(1, 2))


def angles_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp((unit(a[:, :3]) * unit(b[:, :3])).sum(dim=1), -1.0, 1.0))

"""The first optimizer steps of ARTIST's aim-point optimization, in plain PyTorch.

The published objective: every heliostat's motor positions are ``initial + tanh(p) *
scale``, from the motor positions that aim it at the target's centre under the
incident light (``scale`` the smaller margin to the motor limits, at least 1), the
parameters ``p`` starting at 0; the field's flux on the target, summed over the
heliostats and traced with field-wide blocking (:mod:`benchmark.reference.blocking`),
is compared with the ground truth by the KL divergence, and three augmented-Lagrangian
terms hold the flux integral to its epoch-0 value, each heliostat's intercept (its
share of rays that reach the target with power) to its epoch-0 value and every pixel
under the maximum flux density. Each step is one Adam update of ``p`` at the initial
rate, then the multipliers' update.

The flux of the whole field is rendered in blocks of heliostats without a graph first;
the loss and its cotangent of the flux follow; then each block is rendered again with a
graph, every heliostat's rectangle among the blockers, and the cotangent pulled back
to the parameters, so that the memory is that of one block.

Faults planted for the check's limits (``inputs["fault"]``): ``half_batch`` (the flux
of the second half of the heliostats left out), ``blocking_off`` (every ray passes),
``candidates_4`` (4 candidate blockers a heliostat, not the configuration's K).
"""

from __future__ import annotations

import torch

from benchmark.reference import blocking as bl
from benchmark.reference import geometry as geo
from benchmark.reference import render as rn
from benchmark.reference.steps import Adam, Readings, blocks, splat_counts

KL_EPSILON = 1e-12


def trapezoid(size: int, slope: float, plateau: float, device) -> torch.Tensor:
    """``[size]``: 1 on a plateau of ``plateau`` pixels in the middle, falling linearly to 0 over ``slope``."""
    distance = torch.abs(torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2) - plateau / 2
    return 1.0 - torch.clamp(distance / slope, 0.0, 1.0)


def ground_truth(resolution, slope: float, plateau: float, device) -> torch.Tensor:
    """The target distribution ``[H, W]``: the outer product of a vertical and a horizontal trapezoid."""
    width, height = resolution
    return torch.outer(trapezoid(height, slope, plateau, device), trapezoid(width, slope, plateau, device))


def ray_power(dni: float, canting: torch.Tensor, points: int, rays: int) -> float:
    """Each ray's power: the DNI on the heliostat's area (four facet half-extents of each axis
    and a 2 cm gap) over its rays."""
    half = torch.linalg.vector_norm(canting[0, 0], dim=-1)[:2]
    return float(dni * torch.prod(4 * half + 0.02)) / (points * rays)


def rays_and_hits(points, normals, incident, scatter_u, scatter_e, receiver, resolution):
    """The rays of surfaces ``[M, P, 4]`` under incident directions ``[M, 4]``: directions
    ``[M, R, P, 3]`` (the mirror direction turned by the sun's scatter about u, then about e),
    their distance to the receiver hit ``[M, R, P]`` (0 where the ray misses it or meets its
    back), and continuous pixel coordinates and the Lambert cosine ``[M, R, P]`` as
    :func:`benchmark.reference.render.receiver_hits` gives them."""
    width, height = resolution
    d = incident[:, None, :3]
    n = normals[..., :3]
    mirror = d - 2.0 * (d * n).sum(dim=-1, keepdim=True) * n
    x, y, z = (mirror[..., k][:, None, :] for k in range(3))
    cu, su = torch.cos(scatter_u), torch.sin(scatter_u)
    ce, se = torch.cos(scatter_e), torch.sin(scatter_e)
    x1, y1 = cu * x - su * y, su * x + cu * y
    direction = torch.stack([x1, ce * y1 - se * z, se * y1 + ce * z], dim=-1)
    center, plane_normal, size = receiver["center"][:3], receiver["normal"][:3], receiver["size"]
    cosine = (direction * plane_normal).sum(dim=-1)
    front = cosine < 0.0
    origin = points[..., :3][:, None]
    reach = ((center - origin) * plane_normal).sum(dim=-1)
    distance = reach / torch.where(front, cosine, torch.ones_like(cosine))
    hit = origin + direction * distance[..., None]
    pixel_e = (hit[..., 0] + size[0] / 2 - center[0]) / size[0] * (width - 1)
    pixel_u = (hit[..., 2] + size[1] / 2 - center[2]) / size[1] * (height - 1)
    inside = front & (pixel_e >= 0) & (pixel_e <= width - 1) & (pixel_u >= 0) & (pixel_u <= height - 1)
    pixel_e = torch.where(inside, (width - 1) - pixel_e, torch.full_like(pixel_e, -1.0))
    pixel_u = torch.where(inside, pixel_u, torch.full_like(pixel_u, -1.0))
    zero = torch.zeros_like(cosine)
    return direction, torch.where(inside, distance, zero), pixel_e, pixel_u, torch.where(inside, -cosine, zero)


class Field:
    """The optimized field of ``inputs`` (:func:`benchmark.jobs.aim_point_optimization.reference_inputs`):
    its surfaces, the sun's scatter angles drawn from the run's seed, and the motor
    positions of the parameters."""

    def __init__(self, inputs: dict, device):
        field_, options = inputs["field"], inputs["options"]
        self.field, self.options, self.device = field_, options, device
        self.heliostats = field_["positions"].shape[0]
        self.deviations = inputs["deviations"]
        grid = geo.evaluation_grid(*field_["surface_points"], device=device)
        points, normals = geo.nurbs_surfaces(field_["control_points"][:1], field_["canting"][:1],
                                             field_["translations"][:1], grid, field_["degree"])
        self.points, self.normals = points[0], normals[0]
        self.corners = bl.corner_indices(*field_["surface_points"])
        generator = torch.Generator(device=device).manual_seed(inputs["seed"])
        self.scatter_u, self.scatter_e = rn.sun_distortions(generator, self.heliostats, field_["rays"],
                                                            self.points.shape[0], field_["covariance"])
        self.incident = torch.tensor(options["incident"], device=device).expand(self.heliostats, 4)
        aim = field_["receiver"]["aim"].expand(self.heliostats, 4)
        _, self.initial = geo.align_to_aim_points(field_["positions"], self.deviations, field_["static"],
                                                  field_["optimizable"], self.incident, aim)
        low, high = field_["static"][:, 2], field_["static"][:, 3]
        self.scale = torch.clamp(torch.minimum(self.initial - low, high - self.initial), min=1.0)
        self.power = ray_power(options["dni"], field_["canting"], self.points.shape[0], field_["rays"])

    def orientations(self, parameters: torch.Tensor, index) -> torch.Tensor:
        motors = self.initial[index] + torch.tanh(parameters[index]) * self.scale[index]
        field_ = self.field
        return geo.motor_orientations(field_["positions"][index], self.deviations[index], field_["static"][index],
                                      field_["optimizable"][index], motors)

    def rectangles(self, parameters: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every heliostat's rectangle at ``parameters``."""
        corners = self.points[self.corners]  # [4, 4]
        orientation = self.orientations(parameters, slice(None))
        return bl.rectangles((corners @ orientation.transpose(-1, -2))[..., :3])

    def rays(self, parameters: torch.Tensor, part: slice):
        """The block's ray origins ``[M, 1, P, 3]`` and :func:`rays_and_hits`."""
        count = part.stop - part.start
        points, normals = geo.orient(self.points.expand(count, -1, -1), self.normals.expand(count, -1, -1),
                                     self.orientations(parameters, part))
        hits = rays_and_hits(points, normals, self.incident[part], self.scatter_u[part], self.scatter_e[part],
                             self.field["receiver"], self.field["resolution"])
        return points[:, None, :, :3], hits

    def render(self, parameters: torch.Tensor, part: slice, fault: str | None):
        """The block's flux on the target ``[H, W]`` and its intercepts ``[M]``."""
        origins, (direction, distance, pixel_e, pixel_u, cosine) = self.rays(parameters, part)
        power = self.power * cosine
        if fault != "blocking_off":
            field_rectangles = self.rectangles(parameters)
            own = torch.arange(part.start, part.stop, device=self.device)
            count = 4 if fault == "candidates_4" else self.options["candidates"]
            indices, kept = bl.candidates(origins[:, 0], direction, distance, field_rectangles["corners"], own, count)
            power = power * (1.0 - bl.blocked(origins, direction, distance, field_rectangles, indices, kept))
        power = power * rn.MIRROR_REFLECTIVITY
        if fault == "half_batch" and part.start >= self.heliostats // 2:
            power = power * 0.0
        intercepts = (power > 0).flatten(1).sum(dim=1) / power[0].numel()
        return rn.splat(pixel_e, pixel_u, power, self.field["resolution"]).sum(dim=0), intercepts


def aim_point_steps(inputs: dict, steps: int, block: int, device) -> Readings:
    """The first ``steps`` epochs of the aim-point optimization on ``inputs``."""
    options, fault = inputs["options"], inputs.get("fault")
    field = Field(inputs, device)
    truth = ground_truth(inputs["field"]["resolution"], options["slope"], options["plateau"], device)
    width, height = inputs["field"]["resolution"]
    size = inputs["field"]["receiver"]["size"]
    max_per_pixel = float(size[0] * size[1]) / (width * height) * options["max_flux_density"]
    rho_integral, rho_intercept, rho_local = options["rho_integral"], options["rho_intercept"], options["rho_local"]
    parts = blocks(field.heliostats, block)

    def loss_of(flux, intercepts, references, multipliers):
        p = truth / torch.clamp(truth.abs().sum(), min=KL_EPSILON)
        q = flux / torch.clamp(flux.abs().sum(), min=KL_EPSILON)
        kl = (p * (torch.log(p + KL_EPSILON) - torch.log(q + KL_EPSILON))).sum()
        integral, intercept_start = references
        on_integral, on_intercept, on_local = multipliers
        integral_gap = (integral - flux.sum()) / (integral + options["epsilon"])
        shortfall = torch.clamp(integral_gap, min=0.0)
        intercept_gaps = (intercept_start - intercepts) / (intercept_start + options["epsilon"])
        lost = torch.clamp(intercept_gaps, min=0.0)
        excess = (flux - max_per_pixel) / (max_per_pixel + options["epsilon"])
        over = torch.clamp(excess, min=0.0)
        loss = (kl + on_integral * shortfall + 0.5 * rho_integral * shortfall**2
                + (on_intercept * lost + 0.5 * rho_intercept * lost**2).mean()
                + (on_local * over + 0.5 * rho_local * over**2).max())
        return loss, (integral_gap.detach(), intercept_gaps.mean().detach(), excess.max().detach())

    parameters = torch.zeros((field.heliostats, 2), device=device)
    readings = Readings(start=parameters.clone())
    adam = Adam(parameters)
    zero = torch.zeros((), device=device)
    multipliers = (zero, zero, zero)
    references = None
    for epoch in range(steps):
        with torch.no_grad():
            rendered = [field.render(parameters, part, fault) for part in parts]
        flux = torch.stack([part[0] for part in rendered]).sum(dim=0)
        intercepts = torch.cat([part[1] for part in rendered])
        if references is None:
            references = (flux.sum(), intercepts)
        flux.requires_grad_(True)
        loss, gaps = loss_of(flux, intercepts, references, multipliers)
        loss.backward()
        gradient = torch.zeros_like(parameters)
        for part in parts:
            leaf = parameters.detach().clone().requires_grad_(True)
            field.render(leaf, part, fault)[0].backward(flux.grad)
            gradient = gradient + leaf.grad
        readings.losses.append(float(loss.detach()))
        if epoch == 0:
            readings.first_gradient = gradient.clone()
        parameters = adam.step(parameters, gradient, options["rate"])
        multipliers = tuple(torch.clamp(value + rho * gap, min=0.0) for value, rho, gap in
                            zip(multipliers, (rho_integral, rho_intercept, rho_local), gaps))
    readings.end = parameters
    return readings


@torch.no_grad()
def chunk_work(inputs: dict, chunk: int, block: int, device) -> list[dict[str, dict]]:
    """The work of each chunk of ``chunk`` heliostats in field order at the set-up state
    (parameters 0), counted ``block`` heliostats at a time (``block`` divides ``chunk``):
    ``sigma``, the blocking's (heliostats, rays a heliostat, points, candidate slots,
    heliostats with a kept slot, and :func:`benchmark.reference.blocking.pair_counts`
    summed), and ``splat``, the chunk's maps (one a heliostat) as
    :func:`benchmark.reference.steps.splat_counts` counts them."""
    field = Field(inputs, device)
    parameters = torch.zeros((field.heliostats, 2), device=device)
    field_rectangles = field.rectangles(parameters)
    rays = field.points.shape[0] * inputs["field"]["rays"]
    resolution = inputs["field"]["resolution"]
    chunks = []
    for start in range(0, field.heliostats, chunk):
        sigma = dict(heliostats=0, rays=rays, points=field.points.shape[0], slots=inputs["options"]["candidates"],
                     needed=0, kept_slots=0, kept_pairs=0, zero=0, zero_or_dark=0)
        splat = dict(maps=0, rays=0, valid=0, touched=0, width=resolution[0], height=resolution[1])
        for part in blocks(min(chunk, field.heliostats - start), block):
            part = slice(start + part.start, start + part.stop)
            count = part.stop - part.start
            origins, (direction, distance, pixel_e, pixel_u, cosine) = field.rays(parameters, part)
            own = torch.arange(part.start, part.stop, device=device)
            indices, kept = bl.candidates(origins[:, 0], direction, distance, field_rectangles["corners"], own,
                                          inputs["options"]["candidates"])
            counts = bl.pair_counts(origins, direction, distance, cosine, field_rectangles, indices, kept)
            sigma["heliostats"] += count
            sigma["needed"] += int(kept.any(dim=1).sum())
            for key, value in counts.items():
                sigma[key] += int(value.sum())
            taps = splat_counts(count, lambda _, __: (pixel_e, pixel_u, None), parameters, count, resolution)
            for key in ("maps", "rays", "valid", "touched"):
                splat[key] += taps[key]
        chunks.append(dict(sigma=sigma, splat=splat))
    return chunks

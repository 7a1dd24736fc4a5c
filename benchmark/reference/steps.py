"""The first optimizer steps of ARTIST's surface and kinematics reconstructions, in plain PyTorch.

Each step evaluates the objective on the train samples, takes its gradient,
applies the job's gradient rule (the surface's outer-edge lock, the kinematics'
NaN scrub) and one Adam update at the epoch's learning rate. The flux maps of
all samples are rendered in blocks of samples without a graph first; the loss
and its gradient with respect to the maps follow; then each block is rendered
again with a graph and its maps' cotangent pulled back to the parameters, so
that the memory is that of one block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import render as rn


@dataclass
class Readings:
    """What a run's first steps produced: the loss of each step, the first
    gradient and the parameters before the first step and after the last, each a
    tensor, or a list of tensors in the same order, with its leading axis over
    heliostats (one leaf a row)."""

    losses: list[float] = field(default_factory=list)
    first_gradient: torch.Tensor | list[torch.Tensor] | None = None
    start: torch.Tensor | list[torch.Tensor] | None = None
    end: torch.Tensor | list[torch.Tensor] | None = None


class Adam:
    """Adam (betas 0.9 and 0.999, eps 1e-8) on one tensor, with the rate given each step."""

    def __init__(self, parameter: torch.Tensor):
        self.m = torch.zeros_like(parameter)
        self.v = torch.zeros_like(parameter)
        self.t = 0

    def step(self, parameter: torch.Tensor, gradient: torch.Tensor, rate: float) -> torch.Tensor:
        self.t += 1
        self.m = 0.9 * self.m + 0.1 * gradient
        self.v = 0.999 * self.v + 0.001 * gradient * gradient
        m_hat = self.m / (1 - 0.9**self.t)
        v_hat = self.v / (1 - 0.999**self.t)
        return parameter - rate * m_hat / (torch.sqrt(v_hat) + 1e-8)


def cyclic_rate(epoch: int, low: float, high: float, step_size_up: int) -> float:
    """The triangular cyclic learning rate of ``epoch``."""
    cycle = math.floor(1 + epoch / (2 * step_size_up))
    x = abs(epoch / step_size_up - 2 * cycle + 1)
    return low + (high - low) * max(0.0, 1 - x)


def blocks(count: int, size: int) -> list[slice]:
    return [slice(start, min(start + size, count)) for start in range(0, count, size)]


def objective_and_gradient(parameters: torch.Tensor, render_block, head, samples: int, block: int):
    """(loss, gradient, aux) of ``head(maps, parameters)``, with ``maps`` rendered by
    ``render_block(parameters, block_slice)`` block by block."""
    with torch.no_grad():
        maps = torch.cat([render_block(parameters, part) for part in blocks(samples, block)])
    maps.requires_grad_(True)
    leaf = parameters.detach().clone().requires_grad_(True)
    loss, aux = head(maps, leaf)
    loss.backward()
    gradient = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    cotangent = maps.grad
    for part in blocks(samples, block):
        leaf_block = parameters.detach().clone().requires_grad_(True)
        render_block(leaf_block, part).backward(cotangent[part])
        gradient = gradient + leaf_block.grad
    return loss.detach(), gradient, aux


def over_heliostats(per_heliostat_values: torch.Tensor, fault: str | None) -> torch.Tensor:
    """The mean over the heliostats; with the fault ``half_batch``, over the first half
    alone (the other half's samples left out of the batch)."""
    if fault == "half_batch":
        return per_heliostat_values[: per_heliostat_values.shape[0] // 2].mean()
    return per_heliostat_values.mean()


def altered(answers: torch.Tensor, part: slice, fault: str | None) -> torch.Tensor:
    """Answers (flux maps, normals) as produced; with the fault ``altered_answer``, the
    batch's first one zeroed; with ``shifted_answers``, every map moved one pixel along e.
    (``half_batch``, the third fault a workload file may name, is :func:`over_heliostats`'s.)"""
    if fault == "shifted_answers":
        return torch.roll(answers, 1, dims=-1)
    if fault != "altered_answer" or part.start != 0:
        return answers
    keep = torch.ones_like(answers)
    keep[0] = 0.0
    return answers * keep


def per_heliostat(values: torch.Tensor, heliostats: int, reduction: str) -> torch.Tensor:
    """Per heliostat mean, or lower median, of per-sample ``values`` (each heliostat's samples contiguous)."""
    grouped = values.reshape(heliostats, -1)
    if reduction == "mean":
        return grouped.mean(dim=1)
    return torch.sort(grouped, dim=1).values[:, (grouped.shape[1] - 1) // 2]


def split_distortions(inputs: dict, split: str, points: int, device):
    """The sun's scatter angles of the ``split`` ("train" or "test") samples, drawn from
    a generator seeded with the run's seed: the train split's first, then the test split's."""
    generator = torch.Generator(device=device).manual_seed(inputs["seed"])
    field_ = inputs["field"]
    for name in ("train", "test"):
        drawn = rn.sun_distortions(generator, inputs[name]["heliostat"].shape[0], field_["rays"], points,
                                   field_["covariance"])
        if name == split:
            return drawn
    raise ValueError(split)


def surface_rays(inputs: dict, split: str, device):
    """(samples, rays(control_points, block) -> (pixel_e, pixel_u, power)) of a split of
    the surface reconstruction: NURBS surfaces, aligned once to aim at the receiver."""
    field_, data = inputs["field"], inputs[split]
    owner = data["heliostat"]
    grid = geo.evaluation_grid(*field_["surface_points"], device=device)
    scatter_u, scatter_e = split_distortions(inputs, split, grid.shape[0] * field_["canting"].shape[1], device)
    count = owner.shape[0]
    orientations, _ = geo.align_to_aim_points(
        field_["positions"][owner], torch.zeros((count, 4), device=device), field_["static"][owner],
        field_["optimizable"][owner], data["incident"], field_["receiver"]["aim"].expand(count, 4),
    )

    def rays(control_points, part):
        index = owner[part]
        points, normals = geo.nurbs_surfaces(
            control_points[index], field_["canting"][index], field_["translations"][index], grid, field_["degree"]
        )
        points, normals = geo.orient(points, normals, orientations[part])
        return rn.receiver_hits(points, normals, data["incident"][part], scatter_u[part], scatter_e[part],
                                field_["receiver"], field_["resolution"])

    return count, rays


def kinematics_rays(inputs: dict, split: str, device):
    """(samples, rays(deviations, block) -> (pixel_e, pixel_u, power)) of a split of the
    kinematics reconstruction: the ideal surfaces at each sample's motor positions."""
    field_, data = inputs["field"], inputs[split]
    owner = data["heliostat"]
    grid = geo.evaluation_grid(*field_["surface_points"], device=device)
    points, normals = geo.nurbs_surfaces(field_["control_points"][:1], field_["canting"][:1],
                                         field_["translations"][:1], grid, field_["degree"])
    scatter_u, scatter_e = split_distortions(inputs, split, points.shape[1], device)

    def rays(deviations, part):
        index = owner[part]
        orientation = geo.motor_orientations(field_["positions"][index], deviations[index], field_["static"][index],
                                             field_["optimizable"][index], data["motors"][part])
        count = orientation.shape[0]
        p, n = geo.orient(points.expand(count, -1, -1), normals.expand(count, -1, -1), orientation)
        return rn.receiver_hits(p, n, data["incident"][part], scatter_u[part], scatter_e[part], field_["receiver"],
                                field_["resolution"])

    return owner.shape[0], rays


@torch.no_grad()
def splat_counts(samples: int, rays, parameters: torch.Tensor, block: int, resolution) -> dict:
    """The splat's work on a split at ``parameters``: its maps, rays, valid rays (all
    four pixels inside) and touched pixels (the distinct pixels of the valid rays' taps)."""
    width, height = resolution
    total = dict(maps=samples, rays=0, valid=0, touched=0, width=width, height=height)
    for part in blocks(samples, block):
        e, u, _ = rays(parameters, part)
        maps = e.shape[0]
        e, u = e.reshape(maps, -1), u.reshape(maps, -1)
        col, row = torch.floor(e), torch.floor(u)
        keep = (col >= 0) & (col <= width - 2) & (row >= 0) & (row <= height - 2)
        base = (row * width + col).long() + torch.arange(maps, device=e.device)[:, None] * (width * height)
        base = base[keep]
        taps = torch.cat([base, base + 1, base + width, base + width + 1])
        total["rays"] += e.numel()
        total["valid"] += int(keep.sum())
        total["touched"] += int(torch.unique(taps).numel())
    return total


# ---------------------------------------------------------------------------
# Surface reconstruction.
# ---------------------------------------------------------------------------


def edge_lock(gradient: torch.Tensor) -> torch.Tensor:
    """Zero the e and n components of each facet's outer ring of control points."""
    locked = gradient.clone()
    for index in (0, -1):
        locked[:, :, index, :, :2] = 0.0
        locked[:, :, :, index, :2] = 0.0
    return locked


def surface_steps(inputs: dict, steps: int, block: int, device) -> Readings:
    """The first ``steps`` epochs of the surface reconstruction on ``inputs``
    (:func:`benchmark.jobs.surface_reconstruction.reference_inputs`)."""
    field_, train, options = inputs["field"], inputs["train"], inputs["options"]
    if options["weight_smoothness"]:
        raise ValueError("the reference has no smoothness regularizer")
    heliostats = field_["control_points"].shape[0]
    samples, rays = surface_rays(inputs, "train", device)
    eps = options["epsilon"]
    original = field_["control_points"]

    fault = inputs.get("fault")

    def render_block(control_points, part):
        flux = altered(rn.splat(*rays(control_points, part), field_["resolution"]), part, fault)
        return rn.crop_around_center(flux, field_["receiver"])

    with torch.no_grad():
        reference_integrals = torch.cat([render_block(original, part).sum(dim=(1, 2))
                                         for part in blocks(samples, block)])
    multipliers = torch.zeros(heliostats, device=device)

    def head(cropped, control_points):
        flux_loss = per_heliostat(rn.kl_divergence(cropped, train["flux"]), heliostats, "mean")
        relative = (cropped.sum(dim=(1, 2)) - reference_integrals) / (reference_integrals + eps)
        shortfall = per_heliostat(torch.clamp(-options["energy_tolerance"] - relative, min=0.0), heliostats, "mean")
        energy = multipliers * shortfall + 0.5 * options["rho"] * shortfall**2
        ideal = ((control_points - original) ** 2).mean(dim=(2, 3, 4)).sum(dim=1)
        beta = options["weight_ideal"] * flux_loss.mean() / (ideal.mean() + eps)
        return over_heliostats(flux_loss + energy + beta * ideal, fault), shortfall.detach()

    readings = Readings(start=original.clone())
    parameters = original.clone()
    adam = Adam(parameters)
    for epoch in range(steps):
        loss, gradient, shortfall = objective_and_gradient(parameters, render_block, head, samples, block)
        gradient = edge_lock(gradient)
        readings.losses.append(float(loss))
        if epoch == 0:
            readings.first_gradient = gradient.clone()
        parameters = adam.step(parameters, gradient, cyclic_rate(epoch, *options["rates"]))
        multipliers = torch.clamp(multipliers + options["rho"] * shortfall, min=0.0)
    readings.end = parameters
    return readings


# ---------------------------------------------------------------------------
# Kinematics reconstruction.
# ---------------------------------------------------------------------------


def kinematics_steps(inputs: dict, steps: int, block: int, device) -> Readings:
    """The first ``steps`` epochs of the kinematics reconstruction on ``inputs``
    (:func:`benchmark.jobs.kinematics_reconstruction.reference_inputs`), by the
    flux-driven method (focal spots, median over each heliostat's samples) or the
    alignment method (angles between normals, mean over each heliostat's samples)."""
    field_, train, options = inputs["field"], inputs["train"], inputs["options"]
    owner = train["heliostat"]
    heliostats = field_["positions"].shape[0]
    receiver, resolution = field_["receiver"], field_["resolution"]
    fault = inputs.get("fault")
    if options["method"] == "raytracing":
        samples, rays = kinematics_rays(inputs, "train", device)
        measured = rn.receiver_points(rn.centers_of_mass(train["flux"]), receiver, resolution)

        def render_block(deviations, part):
            return altered(rn.splat(*rays(deviations, part), resolution), part, fault)

        def head(flux, deviations):
            spots = rn.receiver_points(rn.centers_of_mass(flux), receiver, resolution)
            distance = torch.linalg.vector_norm(spots - measured, dim=1)
            return over_heliostats(per_heliostat(distance, heliostats, "median"), fault), None
    else:
        positions = field_["positions"][owner]
        reflection = geo.unit(train["spots"][:, :3] - positions[:, :3])
        measured = geo.unit(reflection - train["incident"][:, :3])
        samples = block = owner.shape[0]

        def render_block(deviations, part):
            orientation = geo.motor_orientations(positions, deviations[owner], field_["static"][owner],
                                                 field_["optimizable"][owner], train["motors"])
            return altered(orientation[:, :3, 2], part, fault)

        def head(predicted, deviations):
            return over_heliostats(per_heliostat(rn.angles_between(predicted, measured), heliostats, "mean"),
                                   fault), None

    readings = Readings(start=torch.zeros((heliostats, 4), device=device))
    parameters = readings.start.clone()
    adam = Adam(parameters)
    for epoch in range(steps):
        loss, gradient, _ = objective_and_gradient(parameters, render_block, head, samples, block)
        gradient = torch.nan_to_num(gradient, nan=0.0, posinf=0.0, neginf=0.0)
        readings.losses.append(float(loss))
        if epoch == 0:
            readings.first_gradient = gradient.clone()
        parameters = adam.step(parameters, gradient, options["rate"])
    readings.end = parameters
    return readings

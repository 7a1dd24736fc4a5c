"""The comparison that decides ``correct``: the program's first optimizer steps against the reference's.

The numbers below are worked out for every run; a workload file's ``limits`` name
the ones its cell is held to, each with its limit.

- ``loss_gap``: the largest relative gap between the program's and the reference's
  loss over the compared steps; ``first_loss_gap``: the first step's alone;
- ``gradient_gap``: the first gradient as the program's Adam got it (its first
  moment after one step over 1 - beta1), by the worst leaf (a heliostat's
  parameters): the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same of the parameters' change over the compared steps, over
  the leaves whose reference gradient is at least :data:`MOVING_SHARE` of the median
  leaf's (the others move by round-off alone under Adam);
- ``median_gradient_gap``, ``median_change_gap``: the median leaf's gaps instead of
  the worst leaf's, for objectives in which one leaf's gradient is ill-conditioned.
"""

from __future__ import annotations

import math

import torch

MOVING_SHARE = 1e-3
NUMBERS = ("loss_gap", "first_loss_gap", "gradient_gap", "change_gap", "median_gradient_gap", "median_change_gap")


Leaves = torch.Tensor | list[torch.Tensor]


def tensors(leaves: Leaves) -> list[torch.Tensor]:
    return [leaves] if isinstance(leaves, torch.Tensor) else list(leaves)


def leaf_norms(leaves: Leaves) -> torch.Tensor:
    """The norm of each leaf: each row of each tensor (a heliostat's parameters)."""
    return torch.cat([torch.linalg.vector_norm(tensor.detach().double().cpu().reshape(tensor.shape[0], -1), dim=1)
                      for tensor in tensors(leaves)])


def difference(end: Leaves, start: Leaves) -> list[torch.Tensor]:
    return [after.detach() - before.detach() for after, before in zip(tensors(end), tensors(start), strict=True)]


def leaf_gaps(program: Leaves, reference: Leaves, keep: torch.Tensor | None = None) -> torch.Tensor:
    """Each leaf's gap of norms over the larger of its reference norm and the median leaf's."""
    ours, theirs = leaf_norms(program), leaf_norms(reference)
    if keep is not None:
        ours, theirs = ours[keep], theirs[keep]
    if theirs.numel() == 0:
        return torch.full((1,), math.inf, dtype=torch.float64)
    scale = torch.clamp(theirs, min=float(torch.median(theirs)))
    gaps = torch.abs(ours - theirs) / torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.where((scale == 0) & (ours != 0), torch.full_like(gaps, math.inf), gaps)


def compare(program, reference) -> dict[str, float]:
    """The numbers of :data:`NUMBERS` for two :class:`benchmark.reference.steps.Readings`
    (each parameter a tensor, or a list of them); infinite where the program left a reading out."""
    if len(program.losses) < len(reference.losses) or program.first_gradient is None or program.end is None:
        return dict.fromkeys(NUMBERS, math.inf)
    loss_gaps = [
        abs(ours - theirs) / abs(theirs) if theirs != 0 else (0.0 if ours == 0 else math.inf)
        for ours, theirs in zip(program.losses, reference.losses)
    ]
    reference_gradient = leaf_norms(reference.first_gradient)
    moving = reference_gradient >= MOVING_SHARE * float(torch.median(reference_gradient))
    gradient = leaf_gaps(program.first_gradient, reference.first_gradient)
    change = leaf_gaps(difference(program.end, program.start), difference(reference.end, reference.start), moving)
    return dict(
        loss_gap=max(loss_gaps),
        first_loss_gap=loss_gaps[0],
        gradient_gap=float(gradient.max()),
        change_gap=float(change.max()),
        median_gradient_gap=float(torch.median(gradient)),
        median_change_gap=float(torch.median(change)),
    )


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every limited number within its limit (a NaN is not)."""
    return all(numbers[name] <= limit for name, limit in limits.items())

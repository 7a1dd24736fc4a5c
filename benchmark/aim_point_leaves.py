"""Why the aim-point cell's worst leaves part from the reference: a look, on the card.

    python3 benchmark/aim_point_leaves.py --seeds <n>[,<n>...] [--workload aim1000.aim_point]

For each seed, as a run's set-up and check take them, the port's first steps through
its public entry and the reference's, and then one JSON line a seed:

- ``program`` and ``reference_again``: the compared numbers of the program against the
  reference, and of a second run of the reference against the first on the same seed
  (the card's ``index_add`` sums in another order each run): how far the reference
  parts from itself;
- ``worst_change`` and ``worst_gradient``: the leaves (heliostats) whose change gap and
  first-gradient gap are largest, each with its position, each step's gradient on both
  sides, both sides' change, and its reference first gradient's elements over the
  median nonzero element's;
- ``change_gap_moving_elements``: the worst change gap over the elements whose reference
  first gradient is at least :data:`MOVING_SHARE` of the median nonzero element's, and
  ``first_gradient_sign_flips``: the elements whose first gradient has opposite signs on
  the two sides (Adam moves an element by the rate times the sign in its first step);
- ``candidates``: the heliostats whose kept candidate blockers at the start (the port's
  first forward, the reference's corridor test at parameters 0) differ, by the blockers
  each side alone keeps;
- ``flux``: the KL divergence's weight p / q on the field's map as the reference renders
  it at the start and at each side's parameters before its last step: the lit pixels
  where it passes :data:`FLUX_RATIO`, and the largest pixel over the maximum flux
  density; for each worst leaf, in the same three states, and for the median heliostat
  at the start, the largest weight on a pixel it lights and its flux's share on pixels
  past the ratio.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

import torch  # noqa: E402
from torch.optim.optimizer import register_optimizer_step_pre_hook  # noqa: E402

from benchmark import check, run  # noqa: E402
from benchmark.field import field_arrays  # noqa: E402
from benchmark.reference import aim_point  # noqa: E402
from benchmark.reference import blocking as bl  # noqa: E402
from benchmark.reference import render as rn  # noqa: E402
from benchmark.reference.steps import blocks  # noqa: E402

WORST = 5
FLUX_RATIO = 100.0
MOVING_SHARE = 1e-3
CELL = "aim1000.aim_point"
PORT_BLOCKING = "artist_tpu_torch.raytracing.blocking"


def program_side(job, config, workload, arrays, data, seed, device):
    """The port's first steps, each step's gradient, and its candidates at the start:
    ``{heliostat: kept blockers}`` from the first forwards that cover the field."""
    import importlib

    blocking = importlib.import_module(PORT_BLOCKING)
    select = blocking.select_blocking_candidates
    heliostats = arrays["positions"].shape[0]
    kept: dict[int, set[int]] = {}

    def recording(*args, **kwargs):
        indices, valid = select(*args, **kwargs)
        owners = args[3] if len(args) > 3 else kwargs["ray_primitive_indices"]
        if len(kept) < heliostats:
            for owner, row, keep in zip(owners.tolist(), indices.tolist(), valid.tolist()):
                kept.setdefault(owner, {index for index, k in zip(row, keep) if k})
        return indices, valid

    gradients, states = [], []

    def before(optimizer, args, kwargs):
        weights = [w for g in optimizer.param_groups for w in g["params"]]
        gradients.append(torch.cat([w.grad.detach().double().cpu() for w in weights]))
        states.append(torch.cat([w.detach().clone() for w in weights]))

    blocking.select_blocking_candidates = recording
    handle = register_optimizer_step_pre_hook(before)
    try:
        entry = job.build(config, workload, arrays, data, seed, device)
        readings = run.first_steps(entry, int(workload["check"]["steps"]))
    finally:
        handle.remove()
        blocking.select_blocking_candidates = select
    del entry
    return readings, gradients, states, kept


class RecordingAdam(aim_point.Adam):
    """The reference's Adam, keeping each step's gradient and the parameters before it."""

    log: list[tuple[torch.Tensor, torch.Tensor]] = []

    def step(self, parameter, gradient, rate):
        RecordingAdam.log.append((gradient.detach().double().cpu(), parameter.detach().clone()))
        return super().step(parameter, gradient, rate)


def reference_side(job, inputs, workload, device):
    RecordingAdam.log = []
    adam, aim_point.Adam = aim_point.Adam, RecordingAdam
    try:
        readings = job.reference_steps(inputs, int(workload["check"]["steps"]), int(workload["check"]["block"]),
                                       device)
    finally:
        aim_point.Adam = adam
    return readings, [g for g, _ in RecordingAdam.log], [state for _, state in RecordingAdam.log]


@torch.no_grad()
def reference_look(inputs: dict, block: int, device, parameters: torch.Tensor | None = None):
    """At ``parameters`` (0 where None), as the reference renders them: each heliostat's
    kept blockers, and its flux map's look (largest p / q on a pixel it lights, its flux's
    share on pixels past :data:`FLUX_RATIO`) with the field's lit pixels past it and its
    largest pixel over the maximum flux density, less 1."""
    field = aim_point.Field(inputs, device)
    options = inputs["options"]
    if parameters is None:
        parameters = torch.zeros((field.heliostats, 2), device=device)
    rectangles = field.rectangles(parameters)
    kept: dict[int, set[int]] = {}
    maps = []
    splat = rn.splat

    def keeping(*args):
        out = splat(*args)
        maps.append(out.cpu())
        return out

    rn.splat = keeping
    try:
        for part in blocks(field.heliostats, block):
            origins, (direction, distance, _, _, _) = field.rays(parameters, part)
            own = torch.arange(part.start, part.stop, device=device)
            indices, valid = bl.candidates(origins[:, 0], direction, distance, rectangles["corners"], own,
                                           options["candidates"])
            for owner, row, keep in zip(own.tolist(), indices.tolist(), valid.tolist()):
                kept[owner] = {index for index, k in zip(row, keep) if k}
            field.render(parameters, part, None)
    finally:
        rn.splat = splat
    each = torch.cat(maps).double()  # [heliostats, H, W]
    truth = aim_point.ground_truth(inputs["field"]["resolution"], options["slope"], options["plateau"], "cpu")
    p = truth.double() / truth.sum()
    q = each.sum(dim=0) / each.sum()
    ratio = p / (q + aim_point.KL_EPSILON)
    lit = each > 0
    largest = torch.where(lit, ratio[None], torch.zeros_like(each)).flatten(1).amax(dim=1)
    past = ratio > FLUX_RATIO
    share = (each * past[None]).flatten(1).sum(dim=1) / each.flatten(1).sum(dim=1).clamp(min=1e-300)
    size, (width, height) = inputs["field"]["receiver"]["size"], inputs["field"]["resolution"]
    max_per_pixel = float(size[0] * size[1]) / (width * height) * options["max_flux_density"]
    flux = each.sum(dim=0)  # the reflectivity is in the splat's power
    field_look = dict(lit_pixels=int((q > 0).sum()), lit_pixels_past_ratio=int(((q > 0) & past).sum()),
                      largest_ratio_lit=float(ratio[q > 0].max()),
                      largest_excess=float(flux.max()) / max_per_pixel - 1.0)
    return kept, largest, share, field_look


def leaf_row(leaf, positions, steps_program, steps_reference, change_program, change_reference, median_element,
             gap, looks) -> dict:
    return dict(
        leaf=leaf, east_m=float(positions[leaf, 0]), north_m=float(positions[leaf, 1]), gap=float(gap),
        gradients_program=[g[leaf].tolist() for g in steps_program],
        gradients_reference=[g[leaf].tolist() for g in steps_reference],
        first_gradient_over_median_element=(steps_reference[0][leaf].abs() / median_element).tolist(),
        change_program=change_program[leaf].tolist(), change_reference=change_reference[leaf].tolist(),
        **{f"largest_p_over_q_lit_{state}": float(largest[leaf]) for state, (_, largest, _, _) in looks.items()},
        **{f"flux_share_past_ratio_{state}": float(share[leaf]) for state, (_, _, share, _) in looks.items()},
    )


def look(root: pathlib.Path, name: str, seed: int, device) -> dict:
    _, _, workload, config = run.cell(root, name)
    job = run.job_module(root, config["job"])
    block = int(workload["check"]["block"])
    arrays = field_arrays(config["field"])
    data = job.make_traffic(arrays, workload["traffic_parameters"], seed, device)
    program, steps_program, states_program, kept_program = program_side(job, config, workload, arrays, data, seed,
                                                                        device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inputs = job.reference_inputs(config, workload, arrays, data, seed, device)
    reference, steps_reference, states_reference = reference_side(job, inputs, workload, device)
    again, _, _ = reference_side(job, inputs, workload, device)
    # The start, and each side's parameters before its last step, rendered by the reference.
    looks = {"start": reference_look(inputs, block, device),
             "program_before_last_step": reference_look(inputs, block, device, states_program[-1].to(device)),
             "reference_before_last_step": reference_look(inputs, block, device, states_reference[-1])}
    kept_reference, largest, share, _ = looks["start"]

    first = steps_reference[0]
    median_element = float(torch.median(first.abs()[first != 0]))
    change_program = torch.cat([t.double().cpu() for t in check.difference(program.end, program.start)])
    change_reference = torch.cat([t.double().cpu() for t in check.difference(reference.end, reference.start)])
    leaves_moving = check.leaf_norms(first) >= check.MOVING_SHARE * float(torch.median(check.leaf_norms(first)))
    moving = first.abs() >= MOVING_SHARE * median_element
    change_gaps = torch.full((first.shape[0],), -1.0, dtype=torch.float64)
    change_gaps[leaves_moving] = check.leaf_gaps(change_program, change_reference, leaves_moving)
    gradient_gaps = check.leaf_gaps(program.first_gradient, reference.first_gradient)
    flips = ((steps_program[0] * first) < 0).nonzero().tolist()
    positions = arrays["positions"]

    def rows(gaps):
        return [leaf_row(leaf, positions, steps_program, steps_reference, change_program, change_reference,
                         median_element, gaps[leaf], looks)
                for leaf in torch.argsort(gaps, descending=True)[:WORST].tolist()]

    median_leaf = int(torch.argsort(check.leaf_norms(first))[first.shape[0] // 2])
    differing = {leaf: dict(port_only=sorted(kept_program.get(leaf, set()) - blockers),
                            reference_only=sorted(blockers - kept_program.get(leaf, set())))
                 for leaf, blockers in kept_reference.items() if kept_program.get(leaf, set()) != blockers}
    return {
        "workload": name, "seed": seed,
        "program": check.compare(program, reference),
        "reference_again": check.compare(again, reference),
        "worst_change": rows(change_gaps),
        "worst_gradient": rows(gradient_gaps),
        "change_gap_moving_elements": float(check.leaf_gaps(change_program * moving, change_reference * moving,
                                                            leaves_moving).max()),
        "first_gradient_sign_flips": [dict(leaf=leaf, element=element,
                                           over_median_element=float(first[leaf, element].abs() / median_element))
                                      for leaf, element in flips],
        "candidates": dict(heliostats_compared=len(kept_reference), heliostats_recorded=len(kept_program),
                           kept_slots_reference=sum(len(v) for v in kept_reference.values()),
                           kept_slots_port=sum(len(v) for v in kept_program.values()),
                           differing=differing),
        "flux": {state: field_look for state, (_, _, _, field_look) in looks.items()},
        "median_leaf": dict(leaf=median_leaf, largest_p_over_q_lit=float(largest[median_leaf]),
                            flux_share_past_ratio=float(share[median_leaf]),
                            heliostats_largest_p_over_q_lit_quartiles=torch.quantile(
                                largest, torch.tensor([0.25, 0.5, 0.75, 1.0], dtype=torch.float64)).tolist()),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", default=CELL)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("aim_point_leaves: no CUDA card", file=sys.stderr)
        return 2
    from artist_tpu_torch.kernels.build import build_all

    build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(text) for text in args.seeds.split(",")):
        print(json.dumps(look(run.ROOT, args.workload, seed, torch.device("cuda", 0))), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

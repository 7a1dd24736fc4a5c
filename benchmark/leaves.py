"""Why a cell's worst-leaf numbers swing: each leaf's gradient, program against reference, on the card.

    python3 benchmark/leaves.py --workload <cell> --seeds <n>[,<n>...]

For each seed, as a run's set-up and check take them: the port's first steps through
its public entry, the reference's, and then one JSON line a seed with the compared
numbers, the five leaves (heliostats) whose first-gradient gap is largest (the
program's norm, the reference's, the median leaf's, the gap), where the parameters'
change parts (:func:`change_by_elements`), and what the objective says about those
leaves:

- surface cells: the largest ratio of the measured to the predicted flux (p / q, the
  KL divergence's weight on a pixel) of each heliostat's train images, and the pixels
  lit in the prediction where that ratio passes 100;
- kinematics cells by the alignment method: the smallest angle between a worst
  leaf's kinematic and measured normals over its train samples, and the samples whose
  dot product lies within one fp32 ulp of 1.
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

from benchmark import check, run  # noqa: E402
from benchmark.field import field_arrays  # noqa: E402
from benchmark.reference import geometry as geo  # noqa: E402
from benchmark.reference import render as rn  # noqa: E402
from benchmark.reference import steps  # noqa: E402

WORST = 5
FLUX_RATIO = 100.0
MOVING_SHARE = 1e-3


def surface_look(inputs: dict, block: int, worst: list[int], device) -> dict:
    field_, train = inputs["field"], inputs["train"]
    count, rays = steps.surface_rays(inputs, "train", device)
    with torch.no_grad():
        cropped = torch.cat([
            rn.crop_around_center(rn.splat(*rays(field_["control_points"], part), field_["resolution"]),
                                  field_["receiver"])
            for part in steps.blocks(count, block)
        ])
        p = train["flux"] / train["flux"].sum(dim=(1, 2), keepdim=True)
        q = cropped / cropped.sum(dim=(1, 2), keepdim=True)
        ratio = p / (q + 1e-12)
        owner = train["heliostat"]
        heliostats = field_["control_points"].shape[0]
        largest = torch.zeros(heliostats, dtype=torch.float64, device=device).scatter_reduce_(
            0, owner, ratio.flatten(1).max(dim=1).values.double(), "amax")
        over = torch.zeros(heliostats, dtype=torch.float64, device=device).index_add_(
            0, owner, ((ratio > FLUX_RATIO) & (q > 0)).flatten(1).sum(dim=1).double())
    return {"largest_p_over_q": [float(v) for v in largest.tolist()],
            "lit_pixels_p_over_q_over_100": [int(v) for v in over.tolist()],
            "worst_leaves": worst}


def alignment_look(inputs: dict, worst: list[int], device) -> dict:
    field_, train = inputs["field"], inputs["train"]
    owner = train["heliostat"]
    with torch.no_grad():
        start = torch.zeros((owner.shape[0], 4), device=device)
        orientation = geo.motor_orientations(field_["positions"][owner], start, field_["static"][owner],
                                             field_["optimizable"][owner], train["motors"])
        reflection = geo.unit(train["spots"][:, :3] - field_["positions"][owner][:, :3])
        measured = geo.unit(reflection - train["incident"][:, :3])
        dots = (geo.unit(orientation[:, :3, 2]) * measured).sum(dim=1)
        angles = torch.arccos(torch.clamp(dots, -1.0, 1.0))
    smallest = {leaf: float(angles[owner == leaf].min()) for leaf in worst}
    return {"smallest_angle_rad_of_worst_leaves": smallest,
            "samples_within_an_ulp_of_1": int((dots >= 1 - 2**-23).sum())}


def change_by_elements(program, reference) -> dict:
    """Where the parameters' change parts: the median leaf's change gap over every element
    and over the elements whose reference first gradient is at least :data:`MOVING_SHARE`
    of the median nonzero element's (Adam moves the others by the sign of round-off), and
    the median leaf's share of its reference change that those others make."""
    gradient = torch.cat([t.detach().double().cpu().reshape(t.shape[0], -1)
                          for t in check.tensors(reference.first_gradient)], dim=1).abs()
    ours = torch.cat([t.double().cpu().reshape(t.shape[0], -1)
                      for t in check.difference(program.end, program.start)], dim=1)
    theirs = torch.cat([t.double().cpu().reshape(t.shape[0], -1)
                        for t in check.difference(reference.end, reference.start)], dim=1)
    moving = gradient >= MOVING_SHARE * float(torch.median(gradient[gradient > 0]))
    shares = (theirs * ~moving).pow(2).sum(dim=1) / theirs.pow(2).sum(dim=1).clamp(min=1e-300)
    return {"median_change_gap_every_element": float(torch.median(check.leaf_gaps(ours, theirs))),
            "median_change_gap_moving_elements": float(torch.median(check.leaf_gaps(ours * moving, theirs * moving))),
            "roundoff_elements": int((~moving & (gradient > 0)).sum()),
            "median_share_of_change_in_roundoff_elements": float(torch.median(shares))}


def look(root: pathlib.Path, name: str, seed: int, device) -> dict:
    _, _, workload, config = run.cell(root, name)
    job = run.job_module(root, config["job"])
    count, block = int(workload["check"]["steps"]), int(workload["check"]["block"])
    arrays = field_arrays(config["field"])
    data = job.make_traffic(arrays, workload["traffic_parameters"], seed, device)
    entry = job.build(config, workload, arrays, data, seed, device)
    program = run.first_steps(entry, count)
    del entry
    gc.collect()
    torch.cuda.empty_cache()
    inputs = job.reference_inputs(config, workload, arrays, data, seed, device)
    reference = job.reference_steps(inputs, count, block, device)
    ours, theirs = check.leaf_norms(program.first_gradient), check.leaf_norms(reference.first_gradient)
    gaps = check.leaf_gaps(program.first_gradient, reference.first_gradient)
    worst = torch.argsort(gaps, descending=True)[:WORST].tolist()
    row = {"workload": name, "seed": seed, **check.compare(program, reference),
           "median_leaf_norm": float(torch.median(theirs)),
           "leaves": [{"leaf": leaf, "program": float(ours[leaf]), "reference": float(theirs[leaf]),
                       "gap": float(gaps[leaf])} for leaf in worst],
           **change_by_elements(program, reference)}
    if config["job"] == "surface_reconstruction":
        row.update(surface_look(inputs, block, worst, device))
    elif inputs["options"].get("method") == "alignment":
        row.update(alignment_look(inputs, worst, device))
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("leaves: no CUDA card", file=sys.stderr)
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

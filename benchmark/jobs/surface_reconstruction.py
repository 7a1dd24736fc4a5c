"""The surface reconstruction job: ``SurfaceReconstructor.reconstruct_surfaces`` on the KL divergence.

The configuration's ``optimization`` block is the published section of ARTIST's
field-optimization configuration, read as ARTIST's pipeline reads it; the
reference follows the same steps (:func:`benchmark.reference.steps.surface_steps`).
"""

from __future__ import annotations

import numpy as np

from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.util import constants
from benchmark import traffic
from benchmark.field import reference_field
from benchmark.jobs import common
from benchmark.reference import steps

LAUNCH_COUNTERS = ("artist_tpu_torch.kernels.splat",)
make_traffic = traffic.calibration

CONSTRAINT_KEYS = ("rho_flux_integral", "energy_tolerance", "weight_smoothness", "weight_ideal_surface")
EPSILON = 1e-12  # the reconstructor's default epsilon of its ratios


def build(config: dict, workload: dict, arrays: dict, data: dict, seed: int, device) -> common.Entry:
    section = config["optimization"]
    scenario = common.port_scenario(arrays, device)
    groups = list(scenario.heliostat_groups)
    reconstructor = SurfaceReconstructor(
        scenario=scenario,
        data=common.parser_data(data, int(section["sample_limit"])),
        optimization_configuration={
            constants.optimization: common.block(section, ("initial_learning_rate", *common.OPTIMIZATION_KEYS)),
            constants.scheduler: common.block(section, common.SCHEDULER_KEYS),
            constants.constraints: common.block(section, CONSTRAINT_KEYS),
        },
        number_of_surface_points=arrays["surface_points"],
        bitmap_resolution=arrays["resolution"],
        seed=seed,
        ray_chunk=config["program"]["ray_chunk"],
    )

    def restore():
        scenario.heliostat_groups[:] = groups

    return common.Entry(
        call=lambda on_epoch: reconstructor.reconstruct_surfaces("kl_divergence", on_epoch=on_epoch),
        restore=restore,
        max_epoch=int(section["max_epoch"]),
    )


def reference_inputs(config: dict, workload: dict, arrays: dict, data: dict, seed: int, device) -> dict:
    section = config["optimization"]
    rows = common.split_rows(data["counts"], int(section["sample_limit"]))
    owner = np.repeat(np.arange(len(data["counts"])), data["counts"])
    return dict(
        field=reference_field(arrays, device),
        train=common.reference_split(data, rows["train"], owner, device),
        test=common.reference_split(data, rows["test"], owner, device),
        seed=seed,
        options=dict(
            epsilon=EPSILON,
            energy_tolerance=float(section["energy_tolerance"]),
            rho=float(section["rho_flux_integral"]),
            weight_ideal=float(section["weight_ideal_surface"]),
            weight_smoothness=float(section["weight_smoothness"]),
            rates=(float(section["lr_min"]), float(section["lr_max"]), int(section["step_size_up"])),
        ),
    )


def reference_steps(inputs: dict, count: int, block: int, device) -> steps.Readings:
    return steps.surface_steps(inputs, count, block, device)


def splat_work(inputs: dict, block: int, device) -> dict:
    """The splat's work on each split at the set-up surfaces."""
    start = inputs["field"]["control_points"]
    return {
        split: steps.splat_counts(*steps.surface_rays(inputs, split, device), start, block,
                                  inputs["field"]["resolution"])
        for split in ("train", "test")
    }


def needed_splats(work: dict, calls: list[dict], max_epoch: int, log_step: int) -> list[tuple[str, dict]]:
    """The splats that ``calls`` (each ``{"epochs": n, "stopped": bool}``) need: at a
    call's start the train maps of the energy reference, each epoch the train maps
    and their backward, each validation the test maps."""
    needed = []
    for call in calls:
        needed.append(("forward", work["train"]))
        for epoch in range(call["epochs"]):
            needed += [("forward", work["train"]), ("backward", work["train"])]
            last = epoch == call["epochs"] - 1
            if common.validates(epoch, max_epoch, log_step, call["stopped"] and last):
                needed.append(("forward", work["test"]))
    return needed


def kernel_work(inputs: dict, block: int, calls: list[dict], section: dict, device) -> dict[str, list]:
    """What ``calls`` needed of each kernel family: the splats."""
    return {"splat": needed_splats(splat_work(inputs, block, device), calls, int(section["max_epoch"]),
                                   int(section["log_step"]))}

"""The kinematics reconstruction job: ``KinematicsReconstructor.reconstruct_kinematics``.

The workload's ``method`` picks ARTIST's flux-driven method (``raytracing``: the
focal spots of the traced flux) or its alignment method (``alignment``: the angles
between the kinematic and the measured normals); the configuration's
``optimization`` block is the published section, read as ARTIST's pipeline reads it.
"""

from __future__ import annotations

import numpy as np

from artist_tpu_torch.optim.kinematics_reconstructor import KinematicsReconstructor
from artist_tpu_torch.util import constants
from benchmark import traffic
from benchmark.field import reference_field
from benchmark.jobs import common
from benchmark.reference import steps

LAUNCH_COUNTERS = ("artist_tpu_torch.kernels.splat",)
make_traffic = traffic.calibration


def build(config: dict, workload: dict, arrays: dict, data: dict, seed: int, device) -> common.Entry:
    section = config["optimization"]
    scenario = common.port_scenario(arrays, device)
    groups = list(scenario.heliostat_groups)
    reconstructor = KinematicsReconstructor(
        scenario=scenario,
        data=common.parser_data(data, int(section["sample_limit"])),
        optimization_configuration={
            constants.optimization: common.block(
                section, ("initial_learning_rate_rotation_deviation", *common.OPTIMIZATION_KEYS)
            ),
            constants.scheduler: common.block(section, common.SCHEDULER_KEYS),
        },
        reconstruction_method=workload["traffic_parameters"]["method"],
        bitmap_resolution=arrays["resolution"],
        seed=seed,
    )

    def restore():
        scenario.heliostat_groups[:] = groups

    return common.Entry(
        call=lambda on_epoch: reconstructor.reconstruct_kinematics(on_epoch=on_epoch),
        restore=restore,
        max_epoch=int(section["max_epoch"]),
    )


def reference_inputs(config: dict, workload: dict, arrays: dict, data: dict, seed: int, device) -> dict:
    section = config["optimization"]
    if section["scheduler_type"] != "reduce_on_plateau" or int(section["patience"]) < 3:
        raise ValueError("the reference keeps the initial rate: a plateau scheduler with a patience of 3 or more")
    rows = common.split_rows(data["counts"], int(section["sample_limit"]))
    owner = np.repeat(np.arange(len(data["counts"])), data["counts"])
    return dict(
        field=reference_field(arrays, device),
        train=common.reference_split(data, rows["train"], owner, device),
        test=common.reference_split(data, rows["test"], owner, device),
        seed=seed,
        options=dict(method=workload["traffic_parameters"]["method"],
                     rate=float(section["initial_learning_rate_rotation_deviation"])),
    )


def reference_steps(inputs: dict, count: int, block: int, device) -> steps.Readings:
    return steps.kinematics_steps(inputs, count, block, device)


def splat_work(inputs: dict, block: int, device) -> dict:
    """The splat's work on each split at the set-up deviations (0)."""
    start = inputs["field"]["positions"].new_zeros((inputs["field"]["positions"].shape[0], 4))
    work = {
        split: steps.splat_counts(*steps.kinematics_rays(inputs, split, device), start, block,
                                  inputs["field"]["resolution"])
        for split in ("train", "test")
    }
    work["train_traced"] = inputs["options"]["method"] == constants.kinematics_reconstruction_raytracing
    return work


def needed_splats(work: dict, calls: list[dict], max_epoch: int, log_step: int) -> list[tuple[str, dict]]:
    """The splats that ``calls`` need: each epoch, by the flux-driven method, the
    train maps and their backward; each validation the test maps."""
    needed = []
    for call in calls:
        for epoch in range(call["epochs"]):
            if work["train_traced"]:
                needed += [("forward", work["train"]), ("backward", work["train"])]
            last = epoch == call["epochs"] - 1
            if common.validates(epoch, max_epoch, log_step, call["stopped"] and last):
                needed.append(("forward", work["test"]))
    return needed


def kernel_work(inputs: dict, block: int, calls: list[dict], section: dict, device) -> dict[str, list]:
    """What ``calls`` needed of each kernel family: the splats."""
    return {"splat": needed_splats(splat_work(inputs, block, device), calls, int(section["max_epoch"]),
                                   int(section["log_step"]))}

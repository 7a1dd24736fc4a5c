"""The aim-point optimization job: ``AimPointOptimizer.optimize("kl_divergence")`` on a field
whose blocking keeps slots.

The optimizer is built as the port's field-optimization pipeline builds its aim-point
stage (``examples/field_optimizations/generate_results.py:aim_point_evaluation``): the
configuration's ``optimization`` block is the published section (optimizer, plateau
scheduler, constraints, DNI, the trapezoid's widths), the sun in the south, target 0,
maps of the field's ``bitmap`` (the stage's 256 x 256 in the configuration); the
configuration's ``program`` block gives the stage's options, ``heliostat_chunk`` and
``blocking_candidates``. The traffic is the field's rotation deviations, drawn from the
seed (the state the pipeline's kinematics stage leaves), so that the pre-alignment, and
with it the motor positions the optimization starts from, is the seed's; the sun's
scatter is drawn from the seed by the optimizer.
"""

from __future__ import annotations

import numpy as np
import torch

from artist_tpu_torch.examples.field_optimizations.generate_results import (
    OPTIMIZATION_KEYS,
    SOUTH,
    aim_point_ground_truth,
)
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
from artist_tpu_torch.util import constants
from benchmark import traffic
from benchmark.field import reference_field
from benchmark.jobs import common
from benchmark.reference import aim_point

LAUNCH_COUNTERS = ("artist_tpu_torch.kernels.blocking", "artist_tpu_torch.kernels.splat")
SCHEDULER_KEYS = ("scheduler_type", "lr_min", "reduce_factor", "patience", "threshold", "cooldown")
CONSTRAINT_KEYS = ("rho_flux_integral", "rho_local_flux", "rho_intercept", "max_flux_density")
EPSILON = 1e-12  # the optimizer's default epsilon of its ratios


def make_traffic(arrays: dict, parameters: dict, seed: int, device) -> dict:
    """The field's rotation deviations ``[heliostats, 4]`` (rad), in the workload's range, random signs."""
    rng = np.random.default_rng([seed, 23])
    return dict(deviations=traffic.known_deviations(rng, arrays["positions"].shape[0], parameters["deviation_mrad"]))


def build(config: dict, workload: dict, arrays: dict, data: dict, seed: int, device) -> common.Entry:
    section, program = config["optimization"], config["program"]
    resolution = tuple(arrays["resolution"])  # the stage's AIM_POINT_BITMAP in the configuration
    scenario = common.port_scenario(arrays, device)
    group = scenario.heliostat_groups[0]
    scenario.heliostat_groups[0] = group.replace(
        rotation_deviations=torch.as_tensor(data["deviations"], device=device))
    groups = list(scenario.heliostat_groups)
    optimizer = AimPointOptimizer(
        scenario=scenario,
        optimization_configuration={
            constants.optimization: common.block(section, ("initial_learning_rate", *OPTIMIZATION_KEYS)),
            constants.scheduler: common.block(section, SCHEDULER_KEYS),
            constants.constraints: common.block(section, CONSTRAINT_KEYS),
        },
        incident_ray_direction=list(SOUTH),
        target_area_index=0,
        ground_truth=aim_point_ground_truth(section, resolution),
        dni=float(section["dni"]),
        bitmap_resolution=resolution,
        seed=seed,
        heliostat_chunk=int(program["heliostat_chunk"]),
        blocking_candidates=int(program["blocking_candidates"]),
    )

    def restore():
        scenario.heliostat_groups[:] = groups

    return common.Entry(
        call=lambda on_epoch: optimizer.optimize("kl_divergence", on_epoch=on_epoch),
        restore=restore,
        max_epoch=int(section["max_epoch"]),
    )


def reference_inputs(config: dict, workload: dict, arrays: dict, data: dict, seed: int, device) -> dict:
    section = config["optimization"]
    if section["scheduler_type"] != "reduce_on_plateau" or int(section["patience"]) < 3:
        raise ValueError("the reference keeps the initial rate: a plateau scheduler with a patience of 3 or more")
    return dict(
        field=reference_field(arrays, device),
        deviations=torch.as_tensor(data["deviations"], device=device),
        seed=seed,
        options=dict(
            incident=list(SOUTH),
            dni=float(section["dni"]),
            rate=float(section["initial_learning_rate"]),
            # As the pipeline passes them: the plateau key as the slope's width and the slope key as the plateau's.
            slope=float(section["trapezoid_plateau"]),
            plateau=float(section["trapezoid_slope"]),
            max_flux_density=float(section["max_flux_density"]),
            rho_integral=float(section["rho_flux_integral"]),
            rho_intercept=float(section["rho_intercept"]),
            rho_local=float(section["rho_local_flux"]),
            epsilon=EPSILON,
            candidates=int(config["program"]["blocking_candidates"]),
            chunk=int(config["program"]["heliostat_chunk"]),
        ),
    )


def reference_steps(inputs: dict, count: int, block: int, device):
    return aim_point.aim_point_steps(inputs, count, block, device)


def needed(chunks: list[dict], calls: list[dict]) -> list[tuple[str, dict]]:
    """The launches of one kernel pair that ``calls`` need, each chunk's work (``chunks``):
    a call's epoch-0 references its forwards; each epoch the forwards, the backward's
    recompute of them (where the field runs in several checkpointed chunks) and the backwards."""
    forwards = 2 if len(chunks) > 1 else 1
    launches = []
    for call in calls:
        launches += [("forward", work) for work in chunks]
        for _ in range(call["epochs"]):
            launches += [("forward", work) for work in chunks] * forwards + [("backward", work) for work in chunks]
    return launches


def kernel_work(inputs: dict, block: int, calls: list[dict], section: dict, device) -> dict[str, list]:
    """What ``calls`` needed of each kernel family: the blocking sigma pair's launches and the
    splat's (one map a heliostat), each chunk's work counted on the reference's rays at the
    set-up state."""
    heliostats, chunk = inputs["field"]["positions"].shape[0], inputs["options"]["chunk"]
    if heliostats <= chunk or heliostats % chunk:
        chunk = heliostats  # the optimizer runs such a field unchunked
    chunks = aim_point.chunk_work(inputs, chunk, block, device)
    return {family: needed([work[family] for work in chunks], calls) for family in ("sigma", "splat")}

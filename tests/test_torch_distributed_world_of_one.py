"""The port's multi-process code in a world of one on the CPU, against the JAX package.

Split from ``test_torch_distributed.py`` (the two-rank gloo worlds) with
``test_torch_distributed_phase_16.py``, so that the three files run on three workers; the
checks are the same. World 1 with a ``distributed_setup`` against the JAX package in one
process, on the JAX worker's scene split into two groups, the port handed JAX's sun
distortions: losses and histories to about twice the gap measured between the packages
(``LOSS_RTOL``), and the first gradients likewise (``GRADIENT_LIMIT``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_distributed_worker as worker
from test_torch_aim_point import _jax_objective
from artist_tpu.optim.aim_point_optimizer import AimPointOptimizer as JaxAimPointOptimizer
from artist_tpu.optim.kinematics_reconstructor import KinematicsReconstructor as JaxKinematicsReconstructor
from artist_tpu.optim.surface_reconstructor import SurfaceReconstructor as JaxSurfaceReconstructor
from artist_tpu.scenario.synthetic import SyntheticCalibrationParser as JaxParser
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu.scenario.synthetic import split_into_groups as jax_split_into_groups
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.optim import losses, training
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
from artist_tpu_torch.parallel import setup_distributed_environment
from artist_tpu_torch.util import constants

CPU = torch.device("cpu")
SEED = 7
METHODS = worker.KINEMATICS_METHODS
RAYTRACING, ALIGNMENT = METHODS
OPTIMIZERS = ("surface", RAYTRACING, ALIGNMENT, "aim_point")


@pytest.fixture(scope="module")
def data():
    return worker.kinematics_data()


# --------------------------------------------------------------------------- #
# World 1 against the JAX package.
# --------------------------------------------------------------------------- #


def _as_dict(x):
    import dataclasses

    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _scenes(groups: int = 2):
    """The JAX worker's scene in both packages, split into ``groups`` groups."""
    jax_scenario = jax_synthetic(
        number_of_heliostats=worker.HELIOSTATS, number_of_control_points_per_facet=worker.CONTROL_POINTS,
        number_of_surface_points_per_facet=worker.POINTS, number_of_rays=worker.RAYS,
    )
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position, _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources],
        [_as_dict(group) for group in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names, device="cpu",
    )
    if groups == 1:
        return jax_scenario, scenario
    return jax_split_into_groups(jax_scenario, groups), worker.split_into_groups(scenario, groups)


def _batch_distortions(jax_scenario, mask: np.ndarray) -> list[tuple]:
    """JAX's draws of one group's train and test batches (the split of ``mask``)."""
    split = training.train_test_split(mask, *[np.zeros(int(mask.sum()))] * 5)
    counts = (split.active_heliostats_mask_train.sum(), split.active_heliostats_mask_test.sum())
    points = jax_scenario.heliostat_groups[0].surface_points.shape[1]
    sun = jax_scenario.light_sources[0]
    keys = jax.random.split(jax.random.PRNGKey(SEED))
    return [tuple(np.asarray(x) for x in sun.get_distortions(key, points, int(n))) for key, n in zip(keys, counts)]


# The packages' per-sample flux losses differ by up to ~3e-5 of themselves (fp32
# geometry, sums in other orders).
MEDIAN_TIE = 1e-4


def _median_ties(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per heliostat (rows of ``values``): whether the median's sample (the lower
    middle one) lies within ``MEDIAN_TIE`` of itself of a neighbour in sorted order.
    There the packages' rounding can order the two the other way, and the median
    then carries another sample's gradient."""
    tied = np.zeros(len(values), bool)
    for row, (losses_h, valid_h) in enumerate(zip(values, valid)):
        ordered = np.sort(losses_h[valid_h])
        middle = (len(ordered) - 1) // 2
        gaps = np.diff(ordered)[max(middle - 1, 0) : middle + 1]  # to the median's neighbours
        tied[row] = gaps.size > 0 and gaps.min() <= MEDIAN_TIE * abs(ordered[middle])
    return tied


@pytest.fixture(scope="module")
def against_jax(data):
    """The JAX package in one process, and the port in a world of one, on the same scenes."""
    jax_scenario, _ = _scenes()
    surface_batches = _batch_distortions(jax_scenario, np.full(2, 2, np.int32))
    kinematics_batches = _batch_distortions(jax_scenario, np.full(2, worker.KINEMATICS_SAMPLES, np.int32))
    # The worker draws each group's train batch for the first gradients, then each
    # group's train and test batches for the run.
    queued = {
        "surface": lambda scenario: chip_smoke.QueuedDistortions(
            worker.RAYS, surface_batches[:1] * 2 + surface_batches * 2
        ),
        **{
            m: lambda scenario: chip_smoke.QueuedDistortions(
                worker.RAYS, kinematics_batches[:1] * 2 + kinematics_batches * 2
            )
            for m in METHODS
        },
    }
    theirs: dict = {}
    jax_surface_scenario, _ = _scenes()
    surface = JaxSurfaceReconstructor(
        jax_surface_scenario,
        {constants.data_parser: JaxParser(samples_per_heliostat=2), constants.heliostat_data_mapping: []},
        worker.SURFACE_CONFIGURATION, number_of_surface_points=worker.POINTS, bitmap_resolution=worker.BITMAP,
    )
    for g, gradient in surface.single_step_gradients().items():
        theirs[f"surface_gradient_{g}"] = np.asarray(gradient["gradients"])
        theirs[f"surface_first_loss_{g}"] = np.float64(gradient["loss"])
    theirs["surface_final_loss"], results = surface.reconstruct_surfaces("kl_divergence")
    for result in results:
        theirs[f"surface_history_{result.group_index}"] = np.asarray(result.loss_history["total_loss"])
    for method in METHODS:
        jax_kinematics_scenario, _ = _scenes()
        kinematics = JaxKinematicsReconstructor(
            jax_kinematics_scenario,
            {constants.data_parser: chip_smoke.CalibrationSamples(data), constants.heliostat_data_mapping: []},
            worker.KINEMATICS_CONFIGURATION, reconstruction_method=method, bitmap_resolution=worker.BITMAP,
        )
        for g, gradient in kinematics.single_step_gradients().items():
            theirs[f"{method}_gradient_{g}"] = np.asarray(gradient["gradients"])
        theirs[f"{method}_final_loss"], results = kinematics.reconstruct_kinematics()
        for result in results:
            theirs[f"{method}_history_{result.group_index}"] = np.asarray(result.loss_history)

    # The aim point on the JAX worker's own field (rows 12 m apart: nothing blocks, so
    # JAX's CPU blocking route and the port's compacted one agree) and spot.
    jax_aim_scenario, aim_scenario = _scenes()
    keys = jax.random.split(jax.random.PRNGKey(SEED), 2)
    points = jax_aim_scenario.heliostat_groups[0].surface_points.shape[1]
    aim_draws = [
        tuple(np.asarray(x) for x in jax_aim_scenario.light_sources[0].get_distortions(key, points, 2)) for key in keys
    ]
    aim_scenario.light_sources[0] = chip_smoke.QueuedDistortions(worker.RAYS, aim_draws)
    arguments = dict(
        optimization_configuration=worker.AIM_POINT_CONFIGURATION,
        incident_ray_direction=np.array([0.0, 1.0, 0.0, 0.0], np.float32), target_area_index=0,
        ground_truth=np.ones(worker.BITMAP, np.float32), dni=1000.0, bitmap_resolution=worker.BITMAP,
    )
    jax_aim = JaxAimPointOptimizer(scenario=jax_aim_scenario, **arguments).optimize("kl_divergence")
    theirs["aim_point_final_loss"] = np.float64(jax_aim[0])
    theirs["aim_point_history_total_loss"] = np.asarray(jax_aim[1]["total_loss"])

    # The aim point's first gradient on the scene as one group, under the worker's
    # ground truth, against the JAX loss built from its public functions
    # (``test_torch_aim_point._jax_objective``).
    jax_single, single = _scenes(groups=1)
    single_draw = tuple(
        np.asarray(x) for x in jax_single.light_sources[0].get_distortions(keys[0], points, worker.HELIOSTATS)
    )
    jax_forward, jax_loss = _jax_objective(jax_single, single_draw, worker.aim_point_ground_truth(), "pallas")
    zeros = jnp.zeros((worker.HELIOSTATS, 2))
    flux, intercepts = jax_forward(zeros)
    theirs["aim_point_gradient_0"] = np.asarray(jax.grad(jax_loss)(zeros, (jnp.sum(flux), intercepts), (0.0,) * 3))
    single.light_sources[0] = chip_smoke.FixedDistortions(worker.RAYS, *single_draw)

    # The per-sample losses each median reduction of the port sees: the first two are
    # the raytracing method's first-gradient calls, one a group.
    medians = []
    reduce = losses.reduce_loss_per_heliostat

    def recording(loss_per_sample, indices, valid, reduction="mean"):
        if reduction == "median":
            medians.append(_median_ties(loss_per_sample.detach().numpy()[indices.numpy()], valid.numpy()))
        return reduce(loss_per_sample, indices, valid, reduction)

    with setup_distributed_environment(2, device="cpu") as setup, pytest.MonkeyPatch.context() as patch:
        patch.setattr(losses, "reduce_loss_per_heliostat", recording)
        ours = {}
        for name in ("surface", *METHODS):
            ours.update(worker.run(setup, 2, light_sources={name: queued[name]}, data=data, optimizers=(name,)))
        for g in range(2):
            ours[f"{RAYTRACING}_median_tied_{g}"] = medians[g]
        loss, history, *_ = AimPointOptimizer(scenario=aim_scenario, distributed_setup=setup, **arguments).optimize(
            "kl_divergence"
        )
        ours["aim_point_final_loss"] = np.float64(loss)
        ours["aim_point_history_total_loss"] = np.asarray(history["total_loss"])
    with setup_distributed_environment(1, device="cpu") as setup:
        ours["aim_point_gradient_0"] = worker.aim_point_gradient(
            AimPointOptimizer(scenario=single, distributed_setup=setup, **dict(
                arguments, ground_truth=worker.aim_point_ground_truth()
            ))
        )[0]
    return ours, theirs


# Relative limits on the losses and histories, each about twice the gap measured on
# this scene (surface 6.5e-5, raytracing 5.1e-4, alignment 1.76e-3, aim point
# 1.46e-4); the alignment loss's dots lie ~2.5e-5 below 1, where an fp32 ulp moves
# an angle by 1.2e-3 of itself, so its limit is the single-process tests' 2e-3.
LOSS_RTOL = {"surface": 1e-4, RAYTRACING: 1e-3, ALIGNMENT: 2e-3, "aim_point": 3e-4}
# Limits on the first gradients, as fractions of the largest entry, each about twice
# the gap measured (surface 4.7e-3, raytracing 2.0e-6 off the median's ties,
# alignment 1.1e-3, aim point 5.0e-3). The KL gradients of the surface and the aim
# point weigh pixels that few of the scene's rays reach (4 a point).
GRADIENT_LIMIT = {"surface": 1e-2, RAYTRACING: 1e-5, ALIGNMENT: 2e-3, "aim_point": 1e-2}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_world_of_one_matches_jax(against_jax, optimizer):
    """Losses and histories. Adam moves a parameter by about the rate whatever its
    gradient's size, so entries whose gradients lie within the packages' fp32 noise
    part by up to a step, and the parameters are not compared (as in the
    single-process tests); the first gradients are, below."""
    ours, theirs = against_jax
    keys = [key for key in theirs if key.startswith(optimizer) and ("loss" in key or "history" in key)]
    assert keys
    for key in keys:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=LOSS_RTOL[optimizer], err_msg=key)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_world_of_one_gradient_matches_jax(against_jax, optimizer):
    """The first gradient of each group (the aim point's on the scene as one group).
    The raytracing method reduces a heliostat's samples by their median, which
    hands the gradient of one sample on; where two samples' losses tie within the
    packages' rounding (``_median_ties``) the packages may pick different ones, and
    that heliostat's row is left out. Every group keeps a row."""
    ours, theirs = against_jax
    keys = [key for key in theirs if key.startswith(f"{optimizer}_gradient_")]
    assert len(keys) == (1 if optimizer == "aim_point" else 2)
    for key in keys:
        mine, reference = np.asarray(ours[key]), np.asarray(theirs[key])
        scale = np.abs(reference).max()
        assert scale > 0 and mine.shape == reference.shape, key
        if optimizer == RAYTRACING:
            kept = ~ours[key.replace("gradient", "median_tied")]
            assert kept.any(), key
            mine, reference = mine[kept], reference[kept]
        assert np.abs(mine - reference).max() <= GRADIENT_LIMIT[optimizer] * scale, key

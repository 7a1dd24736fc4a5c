"""The kinematics reconstructor and its losses: the port against the JAX package.

Scenes are the JAX package's synthetic field (4 heliostats, 8 x 8 surface points
a facet, 16 rays a point, 64 x 64 bitmaps) carried into the port with
``convert.py``. Two kinds of calibration data, the same numpy arrays for both
packages:

- both packages' ``SyntheticCalibrationParser`` (bit-equal across them): every
  sample has the same sun, motor positions and focal spot, so the flux-driven
  objective's gradient is 0 there (the traced flux misses the target);
- varied samples (``chip_smoke.kinematics_calibration``, built by the port on
  the CPU): distinct suns, motor positions that aim the ideal heliostat at the
  target, the flux cast with known rotation deviations, focal spots at its
  centre of mass. These identify the deviations.

The port is handed JAX's own sun distortions (the train batch's, then the test
batch's, from ``jax.random.split(PRNGKey(seed))``) through
``chip_smoke.QueuedDistortions``. JAX's CPU splat route is the XLA scatter; the
port follows the Pallas routes, which the scatter matches up to fp32 rounding.

Tolerances, each with its reason:

- ``vector_loss``, ``cosine_similarity_loss``, ``compute_measured_normals``
  and the median: the same fp32 formulas, 1e-6 (relative, or absolute on unit
  vectors);
- ``angle_loss``: the normalized dot products are bit-equal across the
  packages (checked), and ``arccos`` of two libraries may differ by an ulp:
  1e-6 rad; its gradient 1e-5 relative where finite. At a dot of exactly 1
  (and above 1 after rounding) the derivative is infinite: the gradient is
  not finite in the same entries in both packages, and after the scrub (NaN
  and infinities to 0) it is equal;
- ``focal_spot_loss``: the centre of mass and the mapping in fp32 on
  coordinates of 10-50 m: 1e-5 m; its gradient 1e-5 of its largest entry;
- the alignment objective (``single_step_gradients``): no ray, but its dot
  products lie ~2.5e-5 below 1, where an fp32 ulp is 6e-8, and the two
  packages' fp32 kinematic chains put them about an ulp apart. An ulp moves
  an angle of ~7e-3 rad by 6e-8 / 7e-3 ~ 9e-6 rad (1.2e-3 of it) and a
  ``1 - cos`` of 2.7e-5 by 2.2e-3 of it: the loss to 2e-3 relative (measured
  2.5e-4 for the angle, 4.2e-4 for the cosine), the gradient to 5e-3 of its
  largest entry (measured 1.6e-3 and 1.2e-5);
- the flux-driven objective: the trace's fp32 geometry differs by ~1e-4 of
  the flux peak between the packages (``test_torch_splat.py``): the loss to
  1e-4 relative (measured 1.3e-6 to 6e-6); the scrubbed gradient of the focal
  spot and the pixel loss to 1e-3 of its largest entry (measured 4.5e-6 and
  3.1e-4), of the KL loss to 5e-2 (measured 1.7e-2: its ``-p / q`` weighs the
  pixels where a predicted map holds a sliver of a deposit against a
  measured spot elsewhere, at 4,096 rays a 64 x 64 map);
- the loops: histories, final and test losses 1e-3 relative (Adam moves each
  deviation by about the rate whatever its gradient's size, so where a
  gradient entry lies within the packages' noise the two move it by +-lr;
  the losses, which such entries barely move, are compared);
- the recovery test: both packages must bring the deviations closer to the
  known ones, and their distances agree to 1e-2 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.field.solar_tower import SolarTower as JaxSolarTower
from artist_tpu.optim import kinematics_reconstructor as jax_reconstructor
from artist_tpu.optim import losses as jax_losses
from artist_tpu.scenario.synthetic import SyntheticCalibrationParser as JaxParser
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu.util import constants
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.geometry.transforms import _normalize
from artist_tpu_torch.optim import kinematics_reconstructor as reconstructor
from artist_tpu_torch.optim import losses, training
from artist_tpu_torch.parallel import DistributedSetup
from artist_tpu_torch.scenario.synthetic import SyntheticCalibrationParser

HELIOSTATS = 4
POINTS = (8, 8)
RAYS = 16
BITMAP = (64, 64)
SEED = 7
NUM_POINTS = 4 * POINTS[0] * POINTS[1]
CPU = torch.device("cpu")
ALIGNMENT = constants.kinematics_reconstruction_alignment
RAYTRACING = constants.kinematics_reconstruction_raytracing
# Samples a heliostat of the varied data, and the ragged counts the tests keep:
# heliostat 1 has none; the train splits hold 6, 4 and 5 samples (even counts
# for the median), the test splits 2, 1 and 1.
SAMPLES = 8
RAGGED = np.array([8, 0, 5, 6], np.int32)


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _scenarios():
    """The JAX synthetic scene and its port, on the CPU."""
    jax_scenario = jax_synthetic(
        number_of_heliostats=HELIOSTATS, number_of_surface_points_per_facet=POINTS, number_of_rays=RAYS
    )
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position,
        _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources],
        [_as_dict(group) for group in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names,
        device="cpu",
    )
    return jax_scenario, scenario


def _ragged(data, counts: np.ndarray = RAGGED, per_heliostat: int = SAMPLES):
    """The first ``counts[h]`` of each heliostat's samples of ``data``."""
    keep = np.concatenate([h * per_heliostat + np.arange(count) for h, count in enumerate(counts)])
    return dataclasses.replace(
        data,
        flux_measured=data.flux_measured[keep],
        focal_spots=data.focal_spots[keep],
        incident_ray_directions=data.incident_ray_directions[keep],
        motor_positions=data.motor_positions[keep],
        target_area_indices=data.target_area_indices[keep],
        active_heliostats_mask=counts.copy(),
    )


def _varied_data():
    """The varied samples (ragged) and the known deviations they were cast with."""
    _, scenario = _scenarios()
    known = chip_smoke.known_rotation_deviations(HELIOSTATS)
    data = chip_smoke.kinematics_calibration(scenario, known, SAMPLES, BITMAP)
    return _ragged(data), known


def _synthetic_data():
    arguments = dict(
        heliostat_data_mapping=[], heliostat_names=tuple(f"H{i}" for i in range(HELIOSTATS)),
        target_name_to_index={"receiver": 0}, power_plant_position=np.zeros(3), bitmap_resolution=BITMAP,
    )
    return _ragged(SyntheticCalibrationParser(samples_per_heliostat=SAMPLES).parse_data_for_reconstruction(**arguments))


def _configuration(max_epoch: int = 2, scheduler: str = constants.reduce_on_plateau, rate: float = 3e-4) -> dict:
    return {
        constants.optimization: {
            constants.initial_learning_rate_rotation_deviation: rate,
            constants.tolerance: 0.0,
            constants.max_epoch: max_epoch,
            constants.batch_size: 480,
            constants.log_step: 0,
            constants.early_stopping_delta: 1e-9,
            constants.early_stopping_patience: 10_000,
            constants.early_stopping_window: 10_000,
        },
        constants.scheduler: {
            constants.scheduler_type: scheduler,
            constants.gamma: 0.9,
            constants.lr_min: 1e-6,
            constants.reduce_factor: 0.5,
            constants.patience: 0,
            constants.threshold: 1e-3,
            constants.cooldown: 0,
        },
    }


def _jax_distortions(jax_scenario, counts):
    """JAX's draws for the train and the test batch, in that order."""
    keys = jax.random.split(jax.random.PRNGKey(SEED))
    sun = jax_scenario.light_sources[0]
    return [
        tuple(np.asarray(x) for x in sun.get_distortions(key, NUM_POINTS, int(count)))
        for key, count in zip(keys, counts)
    ]


def _reconstructors(method: str, data, configuration: dict, test: bool = True):
    """A JAX and a port reconstructor with ``method`` on the same scene and ``data``;
    the port's light source hands out JAX's distortions (the train batch's, then,
    with ``test``, the test batch's)."""
    jax_scenario, scenario = _scenarios()
    mask = data.active_heliostats_mask
    split = training.train_test_split(mask, *[np.zeros(int(mask.sum()))] * 5)
    counts = [split.active_heliostats_mask_train.sum(), split.active_heliostats_mask_test.sum()]
    scenario.light_sources[0] = chip_smoke.QueuedDistortions(RAYS, _jax_distortions(jax_scenario, counts[: 1 + test]))
    parser = chip_smoke.CalibrationSamples(data)
    common = dict(
        data={constants.data_parser: parser, constants.heliostat_data_mapping: []},
        optimization_configuration=configuration,
        reconstruction_method=method,
        bitmap_resolution=BITMAP,
        seed=SEED,
    )
    return (
        jax_reconstructor.KinematicsReconstructor(jax_scenario, **common),
        reconstructor.KinematicsReconstructor(scenario, **common),
    )


def _jax_tower(tower):
    return JaxSolarTower(
        **{f.name: jnp.asarray(getattr(tower, f.name).numpy()) for f in dataclasses.fields(tower)
           if f.name not in ("planar_names", "cylindrical_names")},
        planar_names=tower.planar_names,
        cylindrical_names=tower.cylindrical_names,
    )


# --------------------------------------------------------------------------- #
# The losses and the measured normals.
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dims", [(1,), (1, 2)])
def test_vector_loss_matches_jax(dims):
    rng = np.random.RandomState(1)
    prediction, truth = rng.randn(2, 5, 6, 3).astype(np.float32)
    ours = losses.vector_loss(torch.tensor(prediction), torch.tensor(truth), dims).numpy()
    theirs = np.asarray(jax_losses.vector_loss(jnp.asarray(prediction), jnp.asarray(truth), dims))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ground_truth", ["bitmaps", "world_points"])
def test_focal_spot_loss_matches_jax(ground_truth):
    """On a tower with a planar and a cylindrical area; one predicted map is empty (its
    flux missed the target), so its centre of mass sits at the pixel corner (0, 0)."""
    tower = chip_smoke.mixed_tower(CPU)
    jax_tower = _jax_tower(tower)
    rng = np.random.RandomState(2)
    height, width = 40, 48
    yy, xx = np.mgrid[0:height, 0:width]
    centres = rng.uniform(8.0, 36.0, (5, 2))
    maps = np.exp(-((xx[None] - centres[:, :1, None]) ** 2 + (yy[None] - centres[:, 1:, None]) ** 2) / 20.0)
    prediction = maps.astype(np.float32)
    prediction[3] = 0.0
    measured = np.roll(maps, 3, axis=2).astype(np.float32)
    targets = np.array([0, 1, 0, 0, 1], np.int32)
    if ground_truth == "world_points":
        measured = np.asarray(
            jax_losses.bitmap_coordinates_to_target_coordinates(
                jax_losses.get_center_of_mass(jnp.asarray(measured)), (width, height), jax_tower, jnp.asarray(targets)
            )
        )
    weights = np.linspace(1.0, 2.0, 5).astype(np.float32)

    def jax_objective(flux):
        values = jax_losses.focal_spot_loss(flux, jnp.asarray(measured), jax_tower, jnp.asarray(targets))
        return jnp.sum(values * weights), values

    (_, theirs), jax_grad = jax.value_and_grad(jax_objective, has_aux=True)(jnp.asarray(prediction))
    flux = torch.tensor(prediction, requires_grad=True)
    ours = losses.focal_spot_loss(flux, torch.tensor(measured), tower, torch.tensor(targets, dtype=torch.long))
    torch.sum(ours * torch.tensor(weights)).backward()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=0, atol=1e-5)
    jax_grad = np.asarray(jax_grad)
    np.testing.assert_allclose(flux.grad.numpy(), jax_grad, rtol=0, atol=1e-5 * np.abs(jax_grad).max())
    assert np.isfinite(flux.grad.numpy()).all() and ours[3] > 1.0  # the empty map's spot lies far off
    assert flux.grad[0].abs().max() > 0


def _angle_cases() -> tuple[np.ndarray, np.ndarray]:
    """Generic pairs, then pairs whose normalized dot product is exactly 1 or above 1
    after rounding (equal vectors; those whose dot rounds below 1 are left out: their
    angle of ~3e-4 rad and its gradient are rounding noise in either package), and
    exactly -1."""
    rng = np.random.RandomState(3)
    generic = rng.randn(2, 6, 4).astype(np.float32)
    same = rng.randn(200, 4).astype(np.float32)
    unit = _normalize(torch.tensor(same[:, :3]))
    same = same[(torch.sum(unit * unit, dim=-1) >= 1).numpy()]
    exact = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 2.0, 0.0], [0.0, 1.0, 0.0, 0.0]], np.float32)
    opposite = np.array([[0.0, 0.0, 3.0, 0.0], [0.0, 0.0, 3.0, 0.0], [0.0, -2.0, 0.0, 0.0]], np.float32)
    prediction = np.concatenate([generic[0], same, exact])
    truth = np.concatenate([generic[1], same, opposite])
    return prediction, truth


def test_angle_loss_and_its_scrubbed_gradient_match_jax():
    prediction, truth = _angle_cases()
    dots = torch.sum(_normalize(torch.tensor(prediction[:, :3])) * _normalize(torch.tensor(truth[:, :3])), dim=-1)
    jax_dots = jnp.sum(
        jax_losses._normalize(jnp.asarray(prediction[:, :3])) * jax_losses._normalize(jnp.asarray(truth[:, :3])),
        axis=-1,
    )
    np.testing.assert_array_equal(dots.numpy(), np.asarray(jax_dots))
    assert (dots > 1).any() and (dots == 1).any() and (dots == -1).any()

    weights = np.linspace(1.0, 2.0, len(prediction)).astype(np.float32)
    theirs, jax_grad = jax.value_and_grad(
        lambda p: jnp.sum(jax_losses.angle_loss(p, jnp.asarray(truth)) * weights)
    )(jnp.asarray(prediction))
    jax_values = np.asarray(jax_losses.angle_loss(jnp.asarray(prediction), jnp.asarray(truth)))
    p = torch.tensor(prediction, requires_grad=True)
    values = losses.angle_loss(p, torch.tensor(truth))
    torch.sum(values * torch.tensor(weights)).backward()
    np.testing.assert_allclose(values.detach().numpy(), jax_values, rtol=0, atol=1e-6)
    grad, jax_grad = p.grad.numpy(), np.asarray(jax_grad)
    # Not finite in the same entries (the rows at a dot of 1 or above, or -1).
    np.testing.assert_array_equal(np.isfinite(grad), np.isfinite(jax_grad))
    assert not np.isfinite(grad[~(np.abs(dots.numpy()) < 1)][:, :3]).any()
    finite = np.isfinite(jax_grad)
    np.testing.assert_allclose(grad[finite], jax_grad[finite], rtol=1e-5, atol=0)
    scrubbed = torch.nan_to_num(p.grad, nan=0.0, posinf=0.0, neginf=0.0).numpy()
    np.testing.assert_allclose(
        scrubbed, np.asarray(jnp.nan_to_num(jax_grad, nan=0.0, posinf=0.0, neginf=0.0)), rtol=1e-5, atol=0
    )
    # torch.clamp would pass the cotangent 0 above 1 and keep the other samples' gradient.
    above = int(np.nonzero(dots.numpy() > 1)[0][0])
    assert np.isnan(grad[above, :3]).all()


def test_cosine_similarity_loss_matches_jax():
    rng = np.random.RandomState(4)
    prediction, truth = rng.randn(2, 7, 3).astype(np.float32)
    prediction[0] = 0.0  # below the norm floor
    ours = losses.cosine_similarity_loss(torch.tensor(prediction), torch.tensor(truth)).numpy()
    theirs = np.asarray(jax_losses.cosine_similarity_loss(jnp.asarray(prediction), jnp.asarray(truth)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)
    assert ours[0] == 1.0


def test_median_of_even_counts_and_its_gradient_match_jax():
    counts = np.array([4, 2, 6, 3, 0], np.int32)
    padded, valid = losses.build_sample_index_matrix(counts)
    values = np.random.RandomState(5).rand(int(counts.sum())).astype(np.float32)
    weights = np.arange(1.0, len(counts) + 1, dtype=np.float32)
    theirs, jax_grad = jax.value_and_grad(
        lambda v: jnp.sum(jax_losses.reduce_loss_per_heliostat(v, padded, valid, "median") * weights)
    )(jnp.asarray(values))
    x = torch.tensor(values, requires_grad=True)
    per_heliostat = losses.reduce_loss_per_heliostat(
        x, torch.tensor(padded, dtype=torch.long), torch.tensor(valid), "median"
    )
    torch.sum(per_heliostat * torch.tensor(weights)).backward()
    expected = np.asarray(jax_losses.reduce_loss_per_heliostat(jnp.asarray(values), padded, valid, "median"))
    np.testing.assert_array_equal(per_heliostat.detach().numpy(), expected)
    # The lower of the two middle elements of an even count.
    np.testing.assert_array_equal(per_heliostat[0].item(), np.sort(values[:4])[1])
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jax_grad))
    assert x.grad.sum() == weights[:4].sum()  # one sample picked a heliostat with data


def test_compute_measured_normals_matches_jax():
    rng = np.random.RandomState(6)
    positions = np.concatenate([rng.uniform(-30, 30, (9, 3)), np.ones((9, 1))], 1).astype(np.float32)
    spots = np.concatenate([rng.uniform(-2, 2, (9, 3)) + [0.0, -3.0, 45.0], np.ones((9, 1))], 1).astype(np.float32)
    incident = np.concatenate([rng.randn(9, 3), np.zeros((9, 1))], 1).astype(np.float32)
    incident[:, :3] /= np.linalg.norm(incident[:, :3], axis=1, keepdims=True)
    ours = reconstructor.compute_measured_normals(*map(torch.tensor, (positions, spots, incident))).numpy()
    theirs = np.asarray(jax_reconstructor.compute_measured_normals(*map(jnp.asarray, (positions, spots, incident))))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(ours[:, :3], axis=1), 1.0, atol=1e-6)
    assert (ours[:, 3] == 0).all()


# --------------------------------------------------------------------------- #
# The objective and the loop.
# --------------------------------------------------------------------------- #

OBJECTIVES = [
    (ALIGNMENT, "angle"), (ALIGNMENT, "cosine_similarity"),
    (RAYTRACING, "focal_spot"), (RAYTRACING, "kl_divergence"), (RAYTRACING, "pixel"),
]


@pytest.mark.parametrize("method,loss", OBJECTIVES, ids=[f"{m}-{loss}" for m, loss in OBJECTIVES])
def test_single_step_gradients_match_jax(method, loss):
    data, _ = _varied_data()
    theirs, ours = _reconstructors(method, data, _configuration(), test=False)
    jax_result = theirs.single_step_gradients(loss)[0]
    result = ours.single_step_gradients(loss)[0]
    np.testing.assert_allclose(result["loss"], jax_result["loss"], rtol=2e-3 if method == ALIGNMENT else 1e-4, atol=0)
    jax_gradients = np.asarray(jax_result["gradients"])
    scale = np.abs(jax_gradients).max()
    assert result["gradients"].shape == (HELIOSTATS, 4) and scale > 0 and np.isfinite(result["gradients"]).all()
    assert (result["gradients"][1] == 0).all()  # heliostat 1 has no sample
    limit = {"angle": 5e-3, "cosine_similarity": 5e-3, "kl_divergence": 5e-2}.get(loss, 1e-3) * scale
    assert np.abs(result["gradients"] - jax_gradients).max() <= limit


LOOP_CASES = {
    "alignment": (ALIGNMENT, constants.reduce_on_plateau, {}),
    "alignment_exponential": (ALIGNMENT, constants.exponential, {}),
    "raytracing": (RAYTRACING, constants.reduce_on_plateau, {}),
    # The window of 2 epochs must improve by 100%: the stop comes at epoch 1, which
    # validates and leaves the history with one entry.
    "raytracing_early_stop": (RAYTRACING, constants.exponential, {
        constants.max_epoch: 5, constants.early_stopping_window: 2, constants.early_stopping_patience: 1,
        constants.early_stopping_delta: 1.0,
    }),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_reconstruct_kinematics_matches_jax(case):
    """A few epochs on the synthetic parser's samples (ragged, heliostat 1 without data)."""
    method, scheduler, optimization = LOOP_CASES[case]
    configuration = _configuration(scheduler=scheduler)
    configuration[constants.optimization].update(optimization)
    theirs, ours = _reconstructors(method, _synthetic_data(), configuration)
    jax_final, (jax_result,) = theirs.reconstruct_kinematics()
    final, (result,) = ours.reconstruct_kinematics()

    expected_epochs = 1 if case.endswith("early_stop") else 3
    assert len(result.loss_history) == len(jax_result.loss_history) == expected_epochs
    np.testing.assert_allclose(result.loss_history, jax_result.loss_history, rtol=1e-3)
    np.testing.assert_array_equal(result.active_heliostat_indices, jax_result.active_heliostat_indices)
    np.testing.assert_array_equal(np.isinf(final), np.isinf(jax_final))
    assert np.isinf(final[1]) and np.isfinite(final[[0, 2, 3]]).all()
    np.testing.assert_allclose(final[np.isfinite(final)], jax_final[np.isfinite(jax_final)], rtol=1e-3)
    np.testing.assert_allclose(result.final_loss_per_heliostat, jax_result.final_loss_per_heliostat, rtol=1e-3)
    assert set(result.test_loss) == set(jax_result.test_loss) == {"pixel_loss", "kl_div", "focal_spot_loss"}
    for key, values in jax_result.test_loss.items():
        np.testing.assert_allclose(result.test_loss[key], np.asarray(values), rtol=1e-3, err_msg=key)
    deviations = ours.scenario.heliostat_groups[0].rotation_deviations
    assert (deviations[1] == 0).all()
    if method == ALIGNMENT:
        assert deviations[[0, 2, 3]].abs().max() > 0


@pytest.mark.parametrize("method", [ALIGNMENT, RAYTRACING])
def test_both_packages_recover_known_deviations(method):
    """Six epochs on the varied samples: each package brings the deviations closer to
    the ones the samples were cast with, and the two agree."""
    data, known = _varied_data()
    theirs, ours = _reconstructors(method, data, _configuration(max_epoch=5, scheduler=constants.exponential))
    _, (jax_result,) = theirs.reconstruct_kinematics()
    _, (result,) = ours.reconstruct_kinematics()
    active = [0, 2, 3]
    before = np.linalg.norm(known[active])
    distances = [
        np.linalg.norm(np.asarray(package.scenario.heliostat_groups[0].rotation_deviations)[active] - known[active])
        for package in (theirs, ours)
    ]
    assert distances[0] < before and distances[1] < before
    np.testing.assert_allclose(distances[1], distances[0], rtol=1e-2)
    assert result.loss_history[-1] < result.loss_history[0]
    np.testing.assert_allclose(result.loss_history, jax_result.loss_history, rtol=1e-3)


def test_unknown_methods_losses_and_unported_options_are_refused():
    _, scenario = _scenarios()
    data = {constants.data_parser: SyntheticCalibrationParser(), constants.heliostat_data_mapping: []}
    with pytest.raises(ValueError, match="unknown"):
        reconstructor.KinematicsReconstructor(scenario, data, _configuration(), "least_squares")
    # mesh and distributed_setup are ported (tests/test_torch_distributed.py runs them): accepted,
    # but a mesh in the group-parallel mode, whose ranks run different groups, is refused.
    setup = DistributedSetup(False, False, 0, 1, {0: [0]}, {0: [0]})
    assert reconstructor.KinematicsReconstructor(scenario, data, _configuration(), distributed_setup=setup).mesh is None
    group_parallel = DistributedSetup(True, False, 0, 2, {0: [0], 1: []}, {0: [0]})
    with pytest.raises(ValueError, match="group-parallel"):
        reconstructor.KinematicsReconstructor(
            scenario, data, _configuration(), mesh=object(), distributed_setup=group_parallel
        )
    for method, loss in ((ALIGNMENT, "focal_spot"), (RAYTRACING, "angle"), (RAYTRACING, "l2")):
        with pytest.raises(ValueError, match="Unknown loss"):
            reconstructor.KinematicsReconstructor(scenario, data, _configuration(), method).reconstruct_kinematics(loss)


def test_chip_smoke_phase_13_runs_on_the_cpu():
    """``chip_smoke.py`` phase 13's functions end to end with the CPU in the card's place,
    at a small size: the alignment method's timed calls, the flux-driven method's,
    its gradient, the resume checks; and the launch rule the card's runs are held to."""
    size = dict(heliostats=6, samples=4, surface_points=(3, 3), rays=2, bitmap=(32, 32))
    alignment, data, known = chip_smoke.drive_kinematics_alignment(CPU, size)
    long = alignment["runs"]["long"]
    assert alignment["runs"]["short"]["epochs"] == 21 and 21 < long["epochs"] <= 49
    # The long call ends at the early stop of epoch 48 or where the loss reaches the tolerance.
    assert (long["epochs"] == 49 and long["stopped"]) or long["history"][-1] <= 5e-4
    assert long["distance_after"] < long["distance_before"]
    flux_size = dict(size, heliostats=4)
    data, known = chip_smoke.flux_driven_samples(CPU, data, known, flux_size)
    assert data.flux_measured.shape == (16, 32, 32) and known.shape == (4, 4)
    raytracing = chip_smoke.drive_kinematics_raytracing(CPU, data, known, flux_size)
    assert raytracing["runs"]["long"]["epochs"] == chip_smoke.KINEMATICS_FLUX_EPOCHS[1] + 1
    assert raytracing["gradient_max_abs"] > 0
    resume = chip_smoke.check_resume(CPU)
    assert all(entry["bit_equal"] for entry in resume.values())
    # Validations at epochs 0 and 19 (max_epoch - 1) of the short call, at 0 and the stop
    # at 48 of the long; one forward and backward an epoch with the flux-driven method.
    assert chip_smoke.kinematics_launches(ALIGNMENT, list(range(21)), 20, 50, False) == chip_smoke.launches(
        splat_forward=2
    )
    assert chip_smoke.kinematics_launches(ALIGNMENT, list(range(49)), 500, 50, True) == chip_smoke.launches(
        splat_forward=2
    )
    assert chip_smoke.kinematics_launches(RAYTRACING, list(range(5)), 4, 50, False) == chip_smoke.launches(
        splat_forward=7, splat_backward=5
    )

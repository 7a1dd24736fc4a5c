"""The surface reconstructor and its pieces: the port against the JAX package.

Scenes are the JAX package's synthetic field (4 heliostats, 6 x 6 control
points and 8 x 8 surface points a facet, 16 rays a point, 64 x 64 bitmaps, ray
chunks of 4) carried into the port with ``convert.py``; calibration data
comes from both packages' ``SyntheticCalibrationParser``. The port is handed
JAX's own sun distortions (the train batch's, then the test batch's, from
``jax.random.split(PRNGKey(seed))``) through ``chip_smoke.QueuedDistortions``.
JAX's reconstructor takes its CPU splat route (the XLA scatter); the port
follows the Pallas routes, which the scatter matches up to fp32 rounding.

Tolerances, each with its reason:

- the parser, the split, the index matrix, the activation map and the edge
  lock are integer or copy work: equal;
- the reductions, the regularizers and ``update_surfaces``: the same fp32
  formulas summed in other orders, 1e-6 (relative, or absolute on surface
  coordinates of order 1 m);
- the crop and its gradient: 1e-5 of their peaks (the centre of mass and the
  bilinear weights in fp32), from the crop in float64, within which both
  packages' fp32 crops fall (their gradients differ from each other by up to
  1.1e-5, from the float64 one by up to 8.3e-6 (JAX) and 3.8e-6 (the port));
- the objective (``single_step_gradients``): the loss and its energy
  constraint term 1e-3 relative, the flux integrals 1e-4 relative, the
  edge-locked gradient 1e-2 of JAX's largest entry. The two packages' fp32
  geometry differs by ~1e-4 of the flux peak, which the crop and the KL
  gradient ``-p / q`` amplify where few rays land: the gap measured here is
  9.9e-4 of the largest entry at 16 rays a point (1.4e-2 at 4 rays a point,
  1,024 rays a 64 x 64 map; about 5e-3 on the render step's scene);
- the loop: the loss histories, the final losses and the test losses 1e-3
  relative. Adam moves every control point by about the learning rate,
  whatever the gradient's size, so where a gradient entry lies within the
  cross-package noise the two packages move it by +-lr: the control points
  are not compared entry by entry, but the losses, which such entries barely
  move, are. The rates stay within 2e-5-1e-4 (measured: two epochs at up to
  1e-4 agree to 5e-6, at 2e-4 the trajectories part by 1.1e-2, as any two
  fp32 runs whose gradients differ in their noise would), and above 1e-5 so
  that the regularizers' squared displacements (~lr^2) stay far above their
  1e-12 balancing epsilon. The mean relative flux-integral difference is
  near 0 in both (JAX's reference integrals come from another compiled
  program than its train step, so its epoch 0 is 4e-8, the port's 0): it is
  compared to 1e-4 absolute, the flux integrals' own relative tolerance; the
  energy-constraint term, a function of it below 1e-3, to 1e-5 absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import SolarTower as JaxSolarTower
from artist_tpu.flux import bitmap as jax_bitmap
from artist_tpu.optim import losses as jax_losses
from artist_tpu.optim import regularizers as jax_regularizers
from artist_tpu.optim import surface_reconstructor as jax_reconstructor
from artist_tpu.optim import training as jax_training
from artist_tpu.scenario.scenario import update_surfaces as jax_update_surfaces
from artist_tpu.scenario.synthetic import SyntheticCalibrationParser as JaxParser
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu.util import constants
from artist_tpu_torch.convert import group_from_numpy, scenario_from_numpy, tower_from_numpy
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.flux import bitmap
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.optim import losses, regularizers, training
from artist_tpu_torch.optim import surface_reconstructor as reconstructor
from artist_tpu_torch.parallel import DistributedSetup
from artist_tpu_torch.scenario.scenario import update_surfaces
from artist_tpu_torch.scenario.synthetic import SyntheticCalibrationParser

HELIOSTATS = 4
CONTROL_POINTS = (6, 6)
POINTS = (8, 8)
RAYS = 16
BITMAP = (64, 64)
RAY_CHUNK = 4
SEED = 7
NUM_POINTS = 4 * POINTS[0] * POINTS[1]
# Ragged sample counts for the loop: heliostat 1 has no data, heliostat 2 one
# sample (its test sample; no train sample, so its train row reduces to 0).
RAGGED = np.array([3, 0, 1, 2], np.int32)
MASKS = [
    np.array([2, 2, 2], np.int32),
    np.array([3, 0, 1, 2, 5], np.int32),
    np.array([4, 0, 0, 7, 1], np.int32),
    np.array([0, 0], np.int32),
    np.array([1], np.int32),
]
MASK_IDS = ["uniform", "ragged", "ragged_zeros", "empty", "single"]


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _scenarios():
    """The JAX synthetic scene and its port, on the CPU."""
    jax_scenario = jax_synthetic(
        number_of_heliostats=HELIOSTATS,
        number_of_control_points_per_facet=CONTROL_POINTS,
        number_of_surface_points_per_facet=POINTS,
        number_of_rays=RAYS,
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


class RaggedParser:
    """Keeps the first ``counts[h]`` of each heliostat's samples of ``parser``
    (which gives every heliostat ``per_heliostat``)."""

    def __init__(self, parser, per_heliostat: int, counts: np.ndarray):
        self.parser, self.per_heliostat, self.counts = parser, per_heliostat, counts

    def parse_data_for_reconstruction(self, **kwargs):
        data = self.parser.parse_data_for_reconstruction(**kwargs)
        keep = np.concatenate(
            [h * self.per_heliostat + np.arange(count) for h, count in enumerate(self.counts)]
        )
        return dataclasses.replace(
            data,
            flux_measured=data.flux_measured[keep],
            focal_spots=data.focal_spots[keep],
            incident_ray_directions=data.incident_ray_directions[keep],
            motor_positions=data.motor_positions[keep],
            target_area_indices=data.target_area_indices[keep],
            active_heliostats_mask=self.counts.copy(),
        )


def _configuration(scheduler: str, max_epoch: int = 2, **optimization) -> dict:
    """Rates of 2e-5 to 1e-4 (the module's note says why)."""
    return {
        constants.optimization: {
            constants.initial_learning_rate: 5e-5,
            constants.tolerance: 0.0,
            constants.max_epoch: max_epoch,
            constants.log_step: 0,
            constants.early_stopping_delta: 1e-9,
            constants.early_stopping_patience: 10_000,
            constants.early_stopping_window: 10_000,
            **optimization,
        },
        constants.scheduler: {
            constants.scheduler_type: scheduler,
            constants.gamma: 0.9,
            constants.lr_min: 2e-5,
            constants.lr_max: 1e-4,
            constants.step_size_up: 2,
            constants.reduce_factor: 0.5,
            constants.patience: 0,
            constants.threshold: 1e-4,
            constants.cooldown: 0,
        },
        constants.constraints: {
            constants.rho_flux_integral: 1.0,
            constants.energy_tolerance: 0.01,
            constants.weight_smoothness: 0.005,
            constants.weight_ideal_surface: 0.1,
        },
    }


def _jax_distortions(jax_scenario, sample_counts):
    """JAX's draws for the train and the test batch, in that order."""
    keys = jax.random.split(jax.random.PRNGKey(SEED))
    sun = jax_scenario.light_sources[0]
    return [
        tuple(np.asarray(x) for x in sun.get_distortions(key, NUM_POINTS, int(count)))
        for key, count in zip(keys, sample_counts)
    ]


def _reconstructors(configuration, parsers, sample_counts, **options):
    """A JAX and a port reconstructor on the same scene and data; the port's light
    source hands out JAX's distortions for ``sample_counts`` (train, test) samples."""
    jax_scenario, scenario = _scenarios()
    scenario.light_sources[0] = chip_smoke.QueuedDistortions(
        RAYS, _jax_distortions(jax_scenario, sample_counts)
    )
    common = dict(
        optimization_configuration=configuration,
        number_of_surface_points=POINTS,
        bitmap_resolution=BITMAP,
        ray_chunk=RAY_CHUNK,
        seed=SEED,
        **options,
    )
    theirs = jax_reconstructor.SurfaceReconstructor(
        jax_scenario, {constants.data_parser: parsers[0], constants.heliostat_data_mapping: []}, **common
    )
    ours = reconstructor.SurfaceReconstructor(
        scenario, {constants.data_parser: parsers[1], constants.heliostat_data_mapping: []}, **common
    )
    return theirs, ours


# --------------------------------------------------------------------------- #
# The pieces.
# --------------------------------------------------------------------------- #


def test_synthetic_calibration_parser_is_bit_equal():
    arguments = dict(
        heliostat_data_mapping=[],
        heliostat_names=("a", "b", "c"),
        target_name_to_index={"receiver": 0},
        power_plant_position=np.zeros(3),
        bitmap_resolution=(48, 32),
    )
    ours = SyntheticCalibrationParser(samples_per_heliostat=3, seed=5).parse_data_for_reconstruction(**arguments)
    theirs = JaxParser(samples_per_heliostat=3, seed=5).parse_data_for_reconstruction(**arguments)
    assert ours.flux_measured.shape == (9, 32, 48)
    for field in dataclasses.fields(ours):
        mine, other = getattr(ours, field.name), getattr(theirs, field.name)
        assert mine.dtype == other.dtype, field.name
        np.testing.assert_array_equal(mine, other, err_msg=field.name)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_train_test_split_matches_jax(mask):
    total = int(mask.sum())
    rng = np.random.RandomState(3)
    arrays = dict(
        flux_measured=rng.rand(total, 4, 5).astype(np.float32),
        focal_spots_measured=rng.rand(total, 4).astype(np.float32),
        incident_ray_directions=rng.rand(total, 4).astype(np.float32),
        motor_positions=rng.rand(total, 2).astype(np.float32),
        target_area_indices=rng.randint(0, 3, total).astype(np.int32),
    )
    ours = training.train_test_split(active_heliostats_mask=mask, **arrays)
    theirs = jax_training.train_test_split(active_heliostats_mask=mask, **arrays)
    for field in dataclasses.fields(ours):
        mine, other = getattr(ours, field.name), getattr(theirs, field.name)
        np.testing.assert_array_equal(mine, other, err_msg=field.name)
        assert np.asarray(mine).dtype == np.asarray(other).dtype, field.name
    np.testing.assert_array_equal(ours.active_heliostats_mask_train + ours.active_heliostats_mask_test, mask)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_sample_index_matrix_and_activation_match_jax(mask):
    padded, valid = losses.build_sample_index_matrix(mask)
    padded_jax, valid_jax = jax_losses.build_sample_index_matrix(mask)
    np.testing.assert_array_equal(padded, padded_jax)
    np.testing.assert_array_equal(valid, valid_jax)
    assert padded.dtype == padded_jax.dtype and valid.dtype == valid_jax.dtype
    active = hg.active_indices_from_mask(mask)
    np.testing.assert_array_equal(active, jax_hg.active_indices_from_mask(mask))
    assert active.dtype == np.int32


@pytest.mark.parametrize("reduction", ["mean", "median"])
def test_reduce_loss_per_heliostat_matches_jax(reduction):
    mask = MASKS[1]
    loss = np.random.RandomState(4).rand(int(mask.sum())).astype(np.float32)
    padded, valid = losses.build_sample_index_matrix(mask)
    ours = losses.reduce_loss_per_heliostat(
        torch.tensor(loss), torch.tensor(padded, dtype=torch.long), torch.tensor(valid), reduction
    )
    theirs = jax_losses.reduce_loss_per_heliostat(jnp.asarray(loss), padded, valid, reduction)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)
    assert ours[1] == 0  # no sample
    with pytest.raises(ValueError):
        losses.reduce_loss_per_heliostat(torch.tensor(loss), torch.tensor(padded), torch.tensor(valid), "max")


@pytest.mark.parametrize("reduction", ["mean", "median"])
def test_reduce_loss_per_sample_matches_jax(reduction):
    loss = np.random.RandomState(5).rand(11).astype(np.float32)  # 3 heliostats x 3, 2 left over
    ours = losses.reduce_loss_per_sample(torch.tensor(loss), 3, reduction)
    theirs = jax_losses.reduce_loss_per_sample(jnp.asarray(loss), 3, reduction)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["smoothness_regularizer", "ideal_surface_regularizer"])
def test_regularizers_match_jax(name):
    rng = np.random.RandomState(6)
    original = rng.rand(3, 4, 6, 5, 3).astype(np.float32)
    current = (original + 1e-2 * rng.randn(*original.shape)).astype(np.float32)
    for dims in ((1,), (1, 0)):
        ours = getattr(regularizers, name)(torch.tensor(current), torch.tensor(original), dims)
        theirs = getattr(jax_regularizers, name)(jnp.asarray(current), jnp.asarray(original), dims)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)


def test_edge_lock_matches_jax():
    gradients = np.random.RandomState(0).randn(2, 4, 6, 7, 3).astype(np.float32)
    ours = reconstructor.lock_control_points_on_outer_edges(torch.tensor(gradients)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_reconstructor.lock_control_points_on_outer_edges(gradients)))
    assert (ours[:, :, [0, -1], :, :2] == 0).all() and (ours[:, :, :, [0, -1], :2] == 0).all()
    np.testing.assert_array_equal(ours[..., 2], gradients[..., 2])


def test_update_surfaces_matches_jax():
    jax_scenario, _ = _scenarios()
    group = jax_scenario.heliostat_groups[0]
    rng = np.random.RandomState(8)
    moved = np.asarray(group.nurbs_control_points) + 1e-2 * rng.randn(*group.nurbs_control_points.shape)
    group = group.replace(nurbs_control_points=jnp.asarray(moved, jnp.float32))
    ours = update_surfaces(group_from_numpy(_as_dict(group), device="cpu"), (7, 5))
    theirs = jax_update_surfaces(group, (7, 5))
    assert ours.surface_points.shape == (HELIOSTATS, 4 * 35, 4)
    np.testing.assert_allclose(ours.surface_points.numpy(), np.asarray(theirs.surface_points), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.surface_normals.numpy(), np.asarray(theirs.surface_normals), rtol=0, atol=1e-6)
    # Re-evaluated from detached control points.
    control_points = ours.nurbs_control_points.clone().requires_grad_(True)
    assert not update_surfaces(ours.replace(nurbs_control_points=control_points)).surface_points.requires_grad


# --------------------------------------------------------------------------- #
# The crop.
# --------------------------------------------------------------------------- #

CROP_SHAPE = (40, 48)  # (height_u, width_e)


def _crop_tower(planar: bool = True, cylindrical: bool = True):
    """A planar area (10 x 8 m) and a cylindrical one (radius 2 m, opening pi / 2:
    an arc of 3.14 m, narrower than the 6 m crop, and 5 m high), or one of them."""
    areas = dict(
        planar_centers=[[0.0, -3.0, 45.0, 1.0]],
        planar_normals=[[0.0, 1.0, 0.0, 0.0]],
        planar_dimensions=[[10.0, 8.0]],
        cylindrical_centers=[[0.0, -5.0, 30.0, 1.0]],
        cylindrical_axes=[[0.0, 0.0, 1.0, 0.0]],
        cylindrical_normals=[[0.0, 1.0, 0.0, 0.0]],
        cylindrical_radii=[2.0],
        cylindrical_heights=[5.0],
        cylindrical_opening_angles=[np.pi / 2],
    )
    kept = {"planar": planar, "cylindrical": cylindrical}
    return JaxSolarTower(
        **{
            name: jnp.asarray(value if kept[name.split("_")[0]] else np.zeros((0,) + np.shape(value)[1:]), jnp.float32)
            for name, value in areas.items()
        },
        planar_names=("receiver",) if planar else (),
        cylindrical_names=("cylinder",) if cylindrical else (),
    )


def _crop_maps():
    """Gaussian spots: central, at the left border, in the top-right corner, and a
    central one on the cylinder; so the window leaves the map and zero padding bites."""
    height, width = CROP_SHAPE
    yy, xx = np.mgrid[0:height, 0:width]
    centres = [(24.3, 19.7), (1.5, 20.2), (45.1, 37.4), (23.2, 18.9)]
    maps = [np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0) for cx, cy in centres]
    noise = np.random.RandomState(9).rand(len(centres), height, width) * 0.005
    return (np.stack(maps) + noise).astype(np.float32), np.array([0, 0, 0, 1], np.int32)


def test_center_of_mass_matches_jax():
    maps, _ = _crop_maps()
    ours = bitmap.get_center_of_mass(torch.tensor(maps)).numpy()
    theirs = np.asarray(jax_bitmap.get_center_of_mass(jnp.asarray(maps)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * max(CROP_SHAPE))
    assert ours[1, 0] < ours[0, 0] - 5  # the spot at the left border pulls the centre there


@pytest.mark.parametrize("tower_kind", ["mixed", "planar", "cylindrical"])
def test_crop_and_its_gradient_match_jax(tower_kind):
    jax_tower = _crop_tower(tower_kind != "cylindrical", tower_kind != "planar")
    maps, targets = _crop_maps()
    if tower_kind != "mixed":
        targets = np.zeros_like(targets)
    tower = tower_from_numpy(_as_dict(jax_tower), device="cpu")
    weights = np.random.RandomState(10).rand(*maps.shape).astype(np.float32)

    def jax_objective(flux):
        cropped = jax_bitmap.crop_flux_distributions_around_center(flux, jax_tower, jnp.asarray(targets))
        return jnp.sum(cropped * weights), cropped

    (_, cropped_jax), grad_jax = jax.value_and_grad(jax_objective, has_aux=True)(jnp.asarray(maps))
    cropped_jax, grad_jax = np.asarray(cropped_jax), np.asarray(grad_jax)

    def port(dtype):
        flux = torch.tensor(maps, dtype=dtype, requires_grad=True)
        cropped = bitmap.crop_flux_distributions_around_center(flux, tower, torch.tensor(targets, dtype=torch.long))
        torch.sum(cropped * torch.tensor(weights, dtype=dtype)).backward()
        return cropped.detach().numpy(), flux.grad.numpy()

    (cropped, grad), exact = port(torch.float32), port(torch.float64)
    assert cropped.shape == maps.shape and cropped.dtype == np.float32
    # Each fp32 crop, its value and its gradient, within 1e-5 of the peak of the
    # float64 one (which the fp32 crops bracket: JAX's gradient is 8.3e-6 of the
    # peak from it, the port's 3.8e-6, on the mixed tower).
    for mine, other, reference in ((cropped, cropped_jax, exact[0]), (grad, grad_jax, exact[1])):
        limit = 1e-5 * np.abs(reference).max()
        np.testing.assert_allclose(mine, reference, rtol=0, atol=limit)
        np.testing.assert_allclose(other, reference, rtol=0, atol=limit)
    np.testing.assert_allclose(cropped, cropped_jax, rtol=0, atol=1e-5 * np.abs(cropped_jax).max())
    # Zero padding bites where the window leaves the map: the left-border spot's
    # crop has an empty column on its left.
    assert (cropped_jax[1, :, 0] == 0).all() and (cropped[1, :, 0] == 0).all()
    assert cropped_jax[1].max() > 0.5 * cropped_jax[0].max()


# --------------------------------------------------------------------------- #
# The objective and the loop.
# --------------------------------------------------------------------------- #


def test_single_step_gradients_match_jax():
    """The full objective at the epoch-0 state and with the energy constraint active
    (reference integrals 5% above the current ones, multipliers 0.5 and up), 4
    heliostats x 2 samples."""
    parsers = (JaxParser(samples_per_heliostat=2), SyntheticCalibrationParser(samples_per_heliostat=2))
    # Two calls, each drawing the train batch's distortions once.
    theirs, ours = _reconstructors(_configuration(constants.exponential), parsers, (HELIOSTATS, HELIOSTATS))
    ours.scenario.light_sources[0].pairs[1] = ours.scenario.light_sources[0].pairs[0]
    jax_plain = theirs.single_step_gradients()[0]
    plain = ours.single_step_gradients()[0]
    np.testing.assert_allclose(plain["flux_integrals"], jax_plain["flux_integrals"], rtol=1e-4, atol=0)
    raised = {0: 1.05 * jax_plain["flux_integrals"]}
    lambdas = {0: np.linspace(0.5, 2.0, HELIOSTATS).astype(np.float32)}
    jax_constrained = theirs.single_step_gradients(
        lambda_flux_integral=lambdas, flux_integrals_reference=raised
    )[0]
    constrained = ours.single_step_gradients(lambda_flux_integral=lambdas, flux_integrals_reference=raised)[0]

    for mine, other in ((plain, jax_plain), (constrained, jax_constrained)):
        np.testing.assert_allclose(mine["loss"], other["loss"], rtol=1e-3, atol=0)
        np.testing.assert_array_equal(mine["lambda_flux_integral"], other["lambda_flux_integral"])
        scale = np.abs(other["gradients"]).max()
        assert scale > 0 and np.isfinite(mine["gradients"]).all()
        assert np.abs(mine["gradients"] - other["gradients"]).max() <= 1e-2 * scale
        assert (mine["gradients"][:, :, [0, -1], :, :2] == 0).all()
    # The energy constraint's term: (lambda c + rho c^2 / 2) with c ~ 0.04 a heliostat.
    term, jax_term = constrained["loss"] - plain["loss"], jax_constrained["loss"] - jax_plain["loss"]
    assert jax_term > 0.01
    np.testing.assert_allclose(term, jax_term, rtol=1e-3, atol=0)


LOOP_CASES = {
    "exponential": (constants.exponential, {}),
    "cyclic": (constants.cyclic, {}),
    "reduce_on_plateau": (constants.reduce_on_plateau, {}),
    # The loss falls below the tolerance after the first epoch.
    "tolerance_stop": (constants.exponential, {constants.tolerance: 1e3}),
    # Windows of 2 epochs must improve by 100%: the stop comes at epoch 1,
    # which validates and leaves the history with one entry.
    "early_stop": (constants.exponential, {
        constants.max_epoch: 5, constants.early_stopping_window: 2, constants.early_stopping_patience: 1,
        constants.early_stopping_delta: 1.0,
    }),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_reconstruct_surfaces_matches_jax(case):
    scheduler, optimization = LOOP_CASES[case]
    parsers = tuple(RaggedParser(parser(samples_per_heliostat=3), 3, RAGGED) for parser in (JaxParser, SyntheticCalibrationParser))
    split = training.train_test_split(RAGGED, *[np.zeros(int(RAGGED.sum()))] * 5)
    counts = (split.active_heliostats_mask_train.sum(), split.active_heliostats_mask_test.sum())
    theirs, ours = _reconstructors(_configuration(scheduler, **optimization), parsers, counts)
    original = ours.scenario.heliostat_groups[0].nurbs_control_points.clone()
    jax_final, (jax_result,) = theirs.reconstruct_surfaces("kl_divergence")
    final, (result,) = ours.reconstruct_surfaces("kl_divergence")

    expected_epochs = {"tolerance_stop": 1, "early_stop": 1}.get(case, 3)
    assert set(result.loss_history) == set(jax_result.loss_history)
    for key, values in jax_result.loss_history.items():
        assert len(result.loss_history[key]) == len(values) == expected_epochs, key
        if key in ("flux_integral", "flux_integral_constraint"):
            atol = 1e-4 if key == "flux_integral" else 1e-5
            np.testing.assert_allclose(result.loss_history[key], values, rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_allclose(result.loss_history[key], values, rtol=1e-3, atol=1e-9, err_msg=key)
    np.testing.assert_array_equal(result.active_heliostat_indices, jax_result.active_heliostat_indices)
    np.testing.assert_array_equal(np.isinf(final), np.isinf(jax_final))
    assert np.isinf(final[1]) and np.isfinite(final[[0, 2, 3]]).all()
    np.testing.assert_allclose(final[np.isfinite(final)], jax_final[np.isfinite(jax_final)], rtol=1e-3)
    np.testing.assert_allclose(result.final_loss_per_heliostat, jax_result.final_loss_per_heliostat, rtol=1e-3)
    assert set(result.test_loss) == {"test_loss_pixel", "test_loss_kl_divergence"} == set(jax_result.test_loss)
    for key, values in jax_result.test_loss.items():
        np.testing.assert_allclose(result.test_loss[key], values, rtol=1e-3, err_msg=key)

    group = ours.scenario.heliostat_groups[0]
    moved = group.nurbs_control_points - original
    assert moved[[0, 2, 3]].abs().max() > 0 and (moved[1] == 0).all()
    assert (moved[:, :, [0, -1], :, :2] == 0).all() and (moved[:, :, :, [0, -1], :2] == 0).all()
    points, _ = evaluate_nurbs_surfaces(
        group.nurbs_control_points, group.nurbs_degrees, create_nurbs_evaluation_grid(POINTS, device="cpu"),
        canting=group.canting, facet_translations=group.facet_translations,
    )
    torch.testing.assert_close(group.surface_points, points.reshape(HELIOSTATS, -1, 4), rtol=0, atol=0)


def test_ray_chunks_do_not_change_the_trajectory():
    """Chunked (recomputed in the backward) against unchunked, port only."""
    histories = {}
    for ray_chunk in (None, RAY_CHUNK):
        _, scenario = _scenarios()
        parser = RaggedParser(SyntheticCalibrationParser(samples_per_heliostat=3), 3, RAGGED)
        ours = reconstructor.SurfaceReconstructor(
            scenario, {constants.data_parser: parser, constants.heliostat_data_mapping: []},
            _configuration(constants.cyclic), number_of_surface_points=POINTS, bitmap_resolution=BITMAP,
            ray_chunk=ray_chunk,
        )
        histories[ray_chunk] = ours.reconstruct_surfaces()[1][0].loss_history["total_loss"]
    assert len(histories[None]) == 3
    np.testing.assert_allclose(histories[RAY_CHUNK], histories[None], rtol=1e-5, atol=0)


class OneRankMesh:
    """A one-rank stand-in for a ``DeviceMesh``: it splits nothing."""

    mesh_dim_names = ("heliostats", "rays")

    def size(self, dim=None) -> int:
        return 1


@pytest.mark.parametrize("option", ["mesh", "distributed_setup", "checkpoint_dir"])
def test_unported_options_are_refused(option, tmp_path):
    """Every option is ported and accepted: ``checkpoint_dir`` (``tests/test_torch_checkpointing.py``
    resumes from it), ``mesh`` and ``distributed_setup`` (``tests/test_torch_distributed.py`` runs
    them). A mesh in the group-parallel mode, whose ranks run different groups, and an unknown
    loss are refused."""
    _, scenario = _scenarios()
    data = {constants.data_parser: SyntheticCalibrationParser(), constants.heliostat_data_mapping: []}
    configuration = _configuration(constants.cyclic)
    if option == "checkpoint_dir":
        ours = reconstructor.SurfaceReconstructor(scenario, data, configuration, checkpoint_dir=tmp_path)
        assert ours.checkpoint_dir == tmp_path
    elif option == "distributed_setup":
        setup = DistributedSetup(False, False, 0, 1, {0: [0]}, {0: [0]})
        ours = reconstructor.SurfaceReconstructor(scenario, data, configuration, distributed_setup=setup)
        assert ours.distributed_setup is setup and ours.mesh is None
    else:
        mesh = OneRankMesh()
        assert reconstructor.SurfaceReconstructor(scenario, data, configuration, mesh=mesh).mesh is mesh
        group_parallel = DistributedSetup(True, False, 0, 2, {0: [0], 1: []}, {0: [0]})
        with pytest.raises(ValueError, match="group-parallel"):
            reconstructor.SurfaceReconstructor(scenario, data, configuration, mesh=mesh, distributed_setup=group_parallel)
    with pytest.raises(ValueError):
        reconstructor.SurfaceReconstructor(scenario, data, _configuration(constants.cyclic)).reconstruct_surfaces("l2")


def test_chip_smoke_phase_7d_runs_on_the_cpu():
    """``chip_smoke.py`` phase 7d's checks run end to end with the CPU in the card's
    place: the small reconstructor's histories and the mixed-tower trace."""
    errors = chip_smoke.check_small_reconstruction_against_cpu(torch.device("cpu"))
    assert set(errors) == set(reconstructor.HISTORY_KEYS)
    assert all(err == 0 for err, _ in errors.values())
    chip_smoke.check_small_mixed_trace_against_cpu(torch.device("cpu"))
    assert chip_smoke.reconstruction_launches(5) == chip_smoke.launches(splat_forward=240, splat_backward=90)

"""The aim-point optimizer and its helpers: the port against the JAX package.

Scenes are the synthetic field with its rows 3 m apart, so that heliostats
block each other (the flagship's 12 m rows block nothing), built by the JAX
package and carried into the port with ``convert.py``; both packages get the
same numpy sun distortions. The JAX loss is built from the JAX package's
public functions with ``blocking_method="pallas"`` (the compacted route the
port follows, in interpret mode). Tolerances, each with its reason:

- schedulers, early stopping and the trapezoid: the same float64 or float32
  arithmetic, so equal to 1e-12 or 1e-6;
- alignment by motor positions: fp32 trigonometry and matrix products, 1e-5;
- the loss to ``rtol = 1e-4``, the epoch-0 references to 1e-4 of their scale
  and the gradient with respect to the tanh parameters to ``1e-3`` of its
  largest entry, as the render step's (fp32 geometry, sums in other orders),
  under a ground truth of ones on the flux spot and zeros off it;
- the optimizer over two epochs: JAX's optimizer takes its dense blocking
  route on the CPU, which culls per primitive instead of per ray; the test
  measures that route's gap to the compacted one on the epoch-0 loss and
  allows three times it, plus the loss's ``rtol = 1e-4`` for rounding. On
  the flat route (``blocking_candidates=None``) the dense route has the
  port's semantics, and the gap measured is the one between JAX's dense and
  flat Pallas routes (sigmoid against one-divide form); the blocking
  factors, ray counts over the same total, agree to ``rtol = 1e-6``.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.flux.bitmap import trapezoid_distribution as jax_trapezoid
from artist_tpu.optim import losses as jax_losses
from artist_tpu.optim import training as jax_training
from artist_tpu.optim.aim_point_optimizer import AimPointOptimizer as JaxAimPointOptimizer
from artist_tpu.raytracing import render as jax_render
from artist_tpu.raytracing.blocking import create_blocking_primitives_rectangles_by_index as jax_rectangles
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu.util import constants, indices
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.flux.bitmap import trapezoid_distribution
from artist_tpu_torch.optim import training
from artist_tpu_torch.optim.aim_point_optimizer import AimPointOptimizer
from artist_tpu_torch.parallel import DistributedSetup

HELIOSTATS = 9  # three rows of three, 3 m apart
POINTS = (5, 5)
RAYS = 4
BITMAP = (32, 32)
DNI = 1000.0
SEED = 7
RHO = {constants.rho_flux_integral: 1.0, constants.rho_intercept: 1.0, constants.rho_local_flux: 1.0}
MAX_FLUX_DENSITY = 1e6
LOSSES = [5.0, 4.0, 3.9, 3.95, 3.96, 3.96, 3.97, 3.5, 3.5, 3.5, 3.5, 3.49, 3.6, 3.7, 3.8, 3.8]


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _jax_scenario(heliostats: int = HELIOSTATS):
    scenario = jax_synthetic(
        number_of_heliostats=heliostats, number_of_surface_points_per_facet=POINTS, number_of_rays=RAYS
    )
    group = scenario.heliostat_groups[0]
    positions = chip_smoke.row_positions(heliostats, chip_smoke.DENSE_ROW_SPACING)
    scenario.heliostat_groups[0] = group.replace(positions=jnp.asarray(positions))
    return scenario


def _port_scenario(jax_scenario, distortions):
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position,
        _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources],
        [_as_dict(g) for g in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names,
        device="cpu",
    )
    scenario.light_sources[0] = chip_smoke.FixedDistortions(RAYS, *distortions)
    return scenario


def _configuration(max_epoch: int) -> dict:
    return {
        constants.optimization: {
            constants.initial_learning_rate: 1e-3,
            constants.tolerance: 0.0,
            constants.max_epoch: max_epoch,
            constants.batch_size: 96,
            constants.log_step: 0,
            constants.early_stopping_delta: 1e-9,
            constants.early_stopping_patience: 10_000,
            constants.early_stopping_window: 10_000,
        },
        constants.scheduler: {constants.scheduler_type: constants.exponential, constants.gamma: 0.99},
        constants.constraints: {**RHO, constants.max_flux_density: MAX_FLUX_DENSITY},
    }


def _jax_distortions(jax_scenario):
    """The distortions JAX's optimizer samples for the scene's one group (seed 7)."""
    key = jax.random.split(jax.random.PRNGKey(SEED), 1)[0]
    group = jax_scenario.heliostat_groups[0]
    points = group.surface_points.shape[1]
    return tuple(
        np.asarray(x)
        for x in jax_scenario.light_sources[0].get_distortions(key, points, group.number_of_heliostats)
    )


def _jax_objective(jax_scenario, distortions, ground_truth, method, candidates=16):
    """The aim-point loss built from the JAX package's public functions.

    Returns ``forward(params) -> (flux, intercepts)`` and ``loss(params,
    references, lambdas) -> loss``, the formulas of
    ``aim_point_optimizer.py:314-528`` for one group.
    """
    group = jax_scenario.heliostat_groups[0]
    tower = jax_scenario.solar_tower
    number = group.number_of_heliostats
    targets = jnp.zeros(number, jnp.int32)
    incident = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0, 0.0], jnp.float32), (number, 4))
    active = jax_hg.gather_active(group, jnp.arange(number))
    initial = jax_hg.align_surfaces_with_incident_ray_directions(active, jax_centers(tower, targets), incident)[3]
    limits = group.actuator_non_optimizable
    scale = jnp.clip(
        jnp.minimum(initial - limits[:, indices.actuator_min_motor_position],
                    limits[:, indices.actuator_max_motor_position] - initial),
        1.0, None,
    )
    magnitude = jax_render.compute_ray_magnitude(DNI, group.canting, group.surface_points.shape[1], RAYS)
    config = jax_render.RenderConfig(
        bitmap_resolution=BITMAP, blocking_active=True, blocking_method=method, blocking_candidates=candidates
    )
    du, de = (jnp.asarray(x) for x in distortions)
    max_density = float(np.prod(np.asarray(tower.planar_dimensions[0])) / np.prod(BITMAP) * MAX_FLUX_DENSITY)

    def forward(params):
        motors = initial + jnp.tanh(params) * scale
        points, normals, _ = jax_hg.align_surfaces_with_motor_positions(active, motors)
        flux, intercepts, _, _ = jax_render.trace_rays(
            tower, points, normals, incident, targets, du, de, ray_magnitude=magnitude,
            blocking_primitives=jax_rectangles(points), ray_primitive_indices=jnp.arange(number), config=config,
        )
        return jax_render.get_bitmaps_per_target(flux, targets, tower.number_of_target_areas)[0], intercepts

    def loss(params, references, lambdas):
        flux, intercepts = forward(params)
        integral, intercept_reference = references
        flux_loss = jax_losses.kl_divergence_loss(flux[None], jnp.asarray(ground_truth)[None])[0]
        a = jnp.clip((integral - jnp.sum(flux)) / (integral + 1e-12), 0.0, None)
        b = jnp.clip((intercept_reference - intercepts) / (intercept_reference + 1e-12), 0.0, None)
        c = jnp.clip((flux - max_density) / (max_density + 1e-12), 0.0, None)
        return (
            flux_loss
            + lambdas[0] * a + 0.5 * a**2
            + jnp.mean(lambdas[1] * b + 0.5 * b**2)
            + jnp.max(lambdas[2] * c + 0.5 * c**2)
        )

    return forward, loss


@pytest.fixture(scope="module")
def scene():
    """The dense-row scene, its distortions and a ground truth of ones on the flux spot."""
    jax_scenario = _jax_scenario()
    distortions = _jax_distortions(jax_scenario)
    forward, _ = _jax_objective(jax_scenario, distortions, np.ones(BITMAP[::-1], np.float32), "pallas")
    flux = np.asarray(forward(jnp.zeros((HELIOSTATS, 2)))[0])
    spot = (flux > 0.05 * flux.max()).astype(np.float32)
    return distortions, spot


@pytest.mark.parametrize("kind", [constants.exponential, constants.cyclic, constants.reduce_on_plateau])
def test_schedulers_match_jax(kind):
    parameters = {
        constants.exponential: {constants.gamma: 0.93},
        constants.cyclic: {constants.lr_min: 1e-5, constants.lr_max: 1e-3, constants.step_size_up: 3},
        constants.reduce_on_plateau: {
            constants.reduce_factor: 0.5, constants.patience: 2, constants.threshold: 1e-3,
            constants.cooldown: 1, constants.lr_min: 1e-4,
        },
    }[kind]
    config = {constants.scheduler_type: kind, **parameters}
    ours, theirs = training.make_scheduler(1e-2, config), jax_training.make_scheduler(1e-2, config)
    if kind == constants.reduce_on_plateau:
        mine = [ours.step(loss) for loss in LOSSES]
        other = [theirs.step(loss) for loss in LOSSES]
        assert len(set(mine)) > 2  # the rate was reduced more than once
    else:
        mine = [ours(epoch) for epoch in range(len(LOSSES))]
        other = [float(theirs(epoch)) for epoch in range(len(LOSSES))]
    np.testing.assert_allclose(mine, other, rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        training.make_scheduler(1e-2, {constants.scheduler_type: "unknown"})


@pytest.mark.parametrize("window, patience, delta", [(3, 2, 1e-2), (5, 1, 0.2), (2, 4, 0.0)])
def test_early_stopping_matches_jax(window, patience, delta):
    ours = training.EarlyStopping(window_size=window, patience=patience, min_improvement=delta)
    theirs = jax_training.EarlyStopping(window_size=window, patience=patience, min_improvement=delta)
    mine = [ours.step(loss) for loss in LOSSES]
    assert mine == [theirs.step(loss) for loss in LOSSES]
    assert any(mine) or window == 2


@pytest.mark.parametrize("width, slope, plateau", [(256, 30, 60), (33, 0, 10), (64, 7, 0)])
def test_trapezoid_distribution_matches_jax(width, slope, plateau):
    np.testing.assert_allclose(
        trapezoid_distribution(width, slope, plateau, device="cpu").numpy(),
        np.asarray(jax_trapezoid(width, slope, plateau)),
        rtol=0, atol=1e-6,
    )


def test_align_surfaces_with_motor_positions_matches_jax():
    jax_scenario = _jax_scenario()
    scenario = _port_scenario(jax_scenario, (np.zeros(1), np.zeros(1)))
    motors = np.random.RandomState(2).uniform(1e4, 6e4, (HELIOSTATS, 2)).astype(np.float32)
    theirs = jax_hg.align_surfaces_with_motor_positions(
        jax_hg.gather_active(jax_scenario.heliostat_groups[0], jnp.arange(HELIOSTATS)), jnp.asarray(motors)
    )
    ours = hg.align_surfaces_with_motor_positions(
        hg.gather_active(scenario.heliostat_groups[0], torch.arange(HELIOSTATS)), torch.tensor(motors)
    )
    for mine, other in zip(ours, theirs):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), rtol=0, atol=1e-5)


def test_aim_point_loss_and_gradient_match_jax(scene):
    distortions, spot = scene
    jax_scenario = _jax_scenario()
    jax_forward, jax_loss = _jax_objective(jax_scenario, distortions, spot, "pallas")
    optimizer = AimPointOptimizer(
        scenario=_port_scenario(jax_scenario, distortions), optimization_configuration=_configuration(1),
        incident_ray_direction=[0.0, 1.0, 0.0, 0.0], target_area_index=0, ground_truth=spot, dni=DNI,
        bitmap_resolution=BITMAP,
    )
    params, forward, loss_fn = optimizer.objective("kl_divergence")

    # The epoch-0 references.
    zeros = jnp.zeros((HELIOSTATS, 2))
    flux_jax, intercepts_jax = (np.asarray(x) for x in jax_forward(zeros))
    with torch.no_grad():
        flux, intercepts, _, blockings = forward(params)
    np.testing.assert_allclose(flux.numpy(), flux_jax, rtol=0, atol=1e-4 * flux_jax.max())
    np.testing.assert_allclose(float(flux.sum()), float(flux_jax.sum()), rtol=1e-4)
    np.testing.assert_allclose(intercepts.numpy(), intercepts_jax, rtol=0, atol=1e-6)
    assert float(blockings.min()) < 1.0  # the scene blocks

    # Loss and gradient away from epoch 0, with the multipliers on.
    theta = np.random.RandomState(4).normal(0.0, 0.05, (HELIOSTATS, 2)).astype(np.float32)
    lambdas = (0.3, 0.2, 0.1)
    references = (float(flux_jax.sum()) * 1.01, intercepts_jax * 1.001)
    loss_jax, grad_jax = jax.value_and_grad(jax_loss)(
        jnp.asarray(theta), (jnp.float32(references[0]), jnp.asarray(references[1])), lambdas
    )
    leaf = torch.tensor(theta, requires_grad=True)
    loss, aux = loss_fn(
        [leaf], (torch.tensor(references[0]), torch.tensor(references[1])),
        tuple(torch.tensor(x) for x in lambdas),
    )
    loss.backward()
    assert float(aux["intercept_constraint"].detach()) > 0 and float(aux["flux_integral_constraint"].detach()) > 0
    np.testing.assert_allclose(loss.item(), float(loss_jax), rtol=1e-4)
    grad_jax = np.asarray(grad_jax)
    assert np.abs(grad_jax).max() > 0
    np.testing.assert_allclose(leaf.grad.numpy(), grad_jax, rtol=0, atol=1e-3 * np.abs(grad_jax).max())


def test_aim_point_optimizer_two_epochs_against_jax(scene):
    distortions, spot = scene
    # The gap between JAX's dense route (its optimizer's CPU default) and the
    # compacted route, measured on the epoch-0 loss.
    zeros = jnp.zeros((HELIOSTATS, 2))
    epoch0 = {}
    for method in ("xla", "pallas"):
        forward, loss = _jax_objective(_jax_scenario(), distortions, spot, method)
        flux, intercepts = forward(zeros)
        epoch0[method] = float(loss(zeros, (jnp.sum(flux), intercepts), (0.0, 0.0, 0.0)))
    gap = abs(epoch0["xla"] - epoch0["pallas"])

    jax_scenario = _jax_scenario()
    scenario = _port_scenario(jax_scenario, distortions)
    kwargs = dict(
        optimization_configuration=_configuration(1), incident_ray_direction=[0.0, 1.0, 0.0, 0.0],
        target_area_index=0, ground_truth=spot, dni=DNI, bitmap_resolution=BITMAP, seed=SEED,
    )
    theirs = JaxAimPointOptimizer(scenario=jax_scenario, **kwargs)
    _, jax_history, *_ = theirs.optimize("kl_divergence")
    ours = AimPointOptimizer(scenario=scenario, **kwargs)
    final_loss, history, intercepts, on_targets, blockings = ours.optimize("kl_divergence")

    assert len(history["total_loss"]) == 2 and final_loss == history["total_loss"][-1]
    for key in ("total_loss", "flux_loss"):
        np.testing.assert_allclose(
            history[key], jax_history[key], rtol=1e-4, atol=3 * gap, err_msg=key
        )
    np.testing.assert_allclose(history["total_loss"][0], epoch0["pallas"], rtol=1e-4)
    assert float(blockings.min()) < 1.0 and intercepts.shape == on_targets.shape == (HELIOSTATS,)
    # The motors moved, within the tanh bound of their scale.
    motors = scenario.heliostat_groups[0].motor_positions
    initial = ours.initial_motor_positions_all_groups[0]
    scale = ours.scales_all_groups[0]
    assert bool((motors != initial).any())
    assert bool(((motors - initial).abs() <= scale * (1 + 1e-6)).all())
    # The write-back, through the tanh parameters each package's motors give
    # back: p = artanh((motors - initial) / scale). Two Adam steps move each p
    # by at most 2 lr. They agree to 1% of one step (lr); measured 4e-6, 0.4% of
    # a step, on a heliostat whose second step nearly cancels its first, where
    # the gradients' rounding weighs most. Every |p| exceeds 0.1 lr, so a
    # write-back in the wrong direction or of half the update fails.
    learning_rate = 1e-3

    def tanh_parameters(optimizer, motors):
        initial = np.asarray(optimizer.initial_motor_positions_all_groups[0], np.float64)
        scale = np.asarray(optimizer.scales_all_groups[0], np.float64)
        return np.arctanh((np.asarray(motors, np.float64) - initial) / scale)

    np.testing.assert_allclose(
        np.asarray(scale), np.asarray(theirs.scales_all_groups[0]), rtol=1e-6
    )
    jax_parameters = tanh_parameters(theirs, jax_scenario.heliostat_groups[0].motor_positions)
    assert np.abs(jax_parameters).min() > 0.1 * learning_rate
    np.testing.assert_allclose(
        tanh_parameters(ours, motors.numpy()), jax_parameters, rtol=0, atol=1e-2 * learning_rate
    )


def test_aim_point_optimizer_flat_route_against_jax(scene):
    """``blocking_candidates=None`` in both packages: the flat route over every primitive
    with the AABB cull, two epochs on the dense-row field."""
    distortions, spot = scene
    zeros = jnp.zeros((HELIOSTATS, 2))
    epoch0 = {}
    for method in ("xla", "pallas"):
        forward, loss = _jax_objective(_jax_scenario(), distortions, spot, method, candidates=None)
        flux, intercepts = forward(zeros)
        epoch0[method] = float(loss(zeros, (jnp.sum(flux), intercepts), (0.0, 0.0, 0.0)))
    gap = abs(epoch0["xla"] - epoch0["pallas"])

    jax_scenario = _jax_scenario()
    scenario = _port_scenario(jax_scenario, distortions)
    kwargs = dict(
        optimization_configuration=_configuration(1), incident_ray_direction=[0.0, 1.0, 0.0, 0.0],
        target_area_index=0, ground_truth=spot, dni=DNI, bitmap_resolution=BITMAP, seed=SEED,
        blocking_candidates=None,
    )
    theirs = JaxAimPointOptimizer(scenario=jax_scenario, **kwargs)
    _, jax_history, _, _, jax_blockings = theirs.optimize("kl_divergence")
    ours = AimPointOptimizer(scenario=scenario, **kwargs)
    assert ours.blocking_candidates is None
    final_loss, history, _, _, blockings = ours.optimize("kl_divergence")

    assert len(history["total_loss"]) == 2 and final_loss == history["total_loss"][-1]
    for key in ("total_loss", "flux_loss"):
        np.testing.assert_allclose(history[key], jax_history[key], rtol=1e-4, atol=3 * gap, err_msg=key)
    np.testing.assert_allclose(history["total_loss"][0], epoch0["pallas"], rtol=1e-4)
    assert float(blockings.min()) < 1.0  # the scene blocks
    np.testing.assert_allclose(blockings.numpy(), np.asarray(jax_blockings), rtol=1e-6, atol=0)  # the same ray counts
    # The written-back motors, through their tanh parameters, to 1% of one Adam step.
    learning_rate = 1e-3

    def tanh_parameters(optimizer, motors):
        initial = np.asarray(optimizer.initial_motor_positions_all_groups[0], np.float64)
        scale = np.asarray(optimizer.scales_all_groups[0], np.float64)
        return np.arctanh((np.asarray(motors, np.float64) - initial) / scale)

    jax_parameters = tanh_parameters(theirs, jax_scenario.heliostat_groups[0].motor_positions)
    assert np.abs(jax_parameters).min() > 0.1 * learning_rate
    np.testing.assert_allclose(
        tanh_parameters(ours, scenario.heliostat_groups[0].motor_positions.numpy()), jax_parameters,
        rtol=0, atol=1e-2 * learning_rate,
    )


def _chunk_kwargs(spot, **options):
    return dict(
        optimization_configuration=_configuration(1), incident_ray_direction=[0.0, 1.0, 0.0, 0.0],
        target_area_index=0, ground_truth=spot, dni=DNI, bitmap_resolution=BITMAP, seed=SEED, **options,
    )


def _assert_runs_agree(ours, theirs, rtol, atol):
    """Two optimize() results: every history entry (rtol, atol) and the intercept, on-target
    and blocking factors (1e-4): the JAX package's tolerances for chunked against unchunked
    (tests/optim/test_aim_point_optimizer.py:140-149)."""
    for key in ours[1]:
        np.testing.assert_allclose(ours[1][key], theirs[1][key], rtol=rtol, atol=atol, err_msg=key)
    for mine, other in zip(ours[2:], theirs[2:]):
        np.testing.assert_allclose(np.asarray(mine), np.asarray(other), rtol=0, atol=1e-4)


def test_aim_point_optimizer_heliostat_chunk_against_jax():
    """``heliostat_chunk=2`` of 4 heliostats (rows 3 m apart) in both packages, with the
    same distortions injected: two epochs. JAX's CPU default blocks on its dense route,
    the port on the compacted one; the histories agree to rtol 1e-4 plus three times the
    two routes' epoch-0 loss gap, as the unchunked test above."""
    heliostats = 4
    jax_scenario = _jax_scenario(heliostats)
    distortions = _jax_distortions(jax_scenario)
    zeros = jnp.zeros((heliostats, 2))
    epoch0 = {}
    for method in ("xla", "pallas"):
        forward, loss = _jax_objective(jax_scenario, distortions, np.ones(BITMAP[::-1], np.float32), method)
        flux, intercepts = forward(zeros)
        epoch0[method] = float(loss(zeros, (jnp.sum(flux), intercepts), (0.0, 0.0, 0.0)))
    spot = (np.asarray(flux) > 0.05 * float(flux.max())).astype(np.float32)
    gap = abs(epoch0["xla"] - epoch0["pallas"])
    kwargs = _chunk_kwargs(spot, heliostat_chunk=2)
    theirs = JaxAimPointOptimizer(scenario=jax_scenario, **kwargs).optimize("kl_divergence")
    optimizer = AimPointOptimizer(scenario=_port_scenario(_jax_scenario(heliostats), distortions), **kwargs)
    assert optimizer.heliostat_chunk == 2
    ours = optimizer.optimize("kl_divergence")
    assert len(ours[1]["total_loss"]) == 2
    for key in ("total_loss", "flux_loss"):
        np.testing.assert_allclose(ours[1][key], theirs[1][key], rtol=1e-4, atol=3 * gap, err_msg=key)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(theirs[2]), rtol=0, atol=1e-4)  # intercepts


@pytest.mark.parametrize("candidates", [16, None], ids=["compacted", "flat"])
def test_heliostat_chunk_matches_unchunked(scene, candidates):
    """Chunks of 3 of the 9 dense-row heliostats against the unchunked run, two epochs, on
    the compacted and the flat route: JAX's tolerances for the same comparison."""
    distortions, spot = scene
    runs = {}
    for chunk in (None, 3):
        optimizer = AimPointOptimizer(
            scenario=_port_scenario(_jax_scenario(), distortions),
            **_chunk_kwargs(spot, heliostat_chunk=chunk, blocking_candidates=candidates),
        )
        runs[chunk] = optimizer.optimize("kl_divergence")
    assert float(runs[3][4].min()) < 1.0  # blocking crosses the chunks
    _assert_runs_agree(runs[3], runs[None], rtol=2e-4, atol=1e-6)


def test_heliostat_chunk_that_does_not_divide_runs_unchunked_with_a_warning(scene, caplog):
    distortions, spot = scene
    runs = {}
    for chunk in (None, 2, 9):
        optimizer = AimPointOptimizer(
            scenario=_port_scenario(_jax_scenario(), distortions), **_chunk_kwargs(spot, heliostat_chunk=chunk)
        )
        with caplog.at_level(logging.WARNING, logger="artist_tpu_torch.optim"):
            caplog.clear()
            runs[chunk] = optimizer.optimize("kl_divergence")
        warned = [r for r in caplog.records if "does not divide" in r.getMessage()]
        assert len(warned) == (1 if chunk == 2 else 0)
    # Unchunked, all three: a chunk of 2 does not divide 9, one of 9 covers the group.
    for chunk in (2, 9):
        for key in runs[None][1]:
            assert runs[chunk][1][key] == runs[None][1][key]


def test_chunk_recompute_repeats_the_candidate_selection(scene):
    """Each chunk's backward recomputes its forward: the corridor test's top-K and the
    gathered columns come out the same, so each recomputed sigma call's inputs equal its
    forward call's bit for bit."""
    distortions, spot = scene
    optimizer = AimPointOptimizer(
        scenario=_port_scenario(_jax_scenario(), distortions), **_chunk_kwargs(spot, heliostat_chunk=3)
    )
    params, forward, loss_fn = optimizer.objective("kl_divergence")
    with torch.no_grad():
        flux, intercepts, _, _ = forward(params)
    for param in params:
        param.requires_grad_(True)
    capture = chip_smoke.CaptureBlockingInputs()
    with capture:
        loss, _ = loss_fn(params, (flux.sum(), intercepts), (torch.zeros(()),) * 3)
        calls_forward = len(capture.calls["blocking_sigma"])
        loss.backward()
    calls = capture.calls["blocking_sigma"]
    assert calls_forward == 3 and len(calls) == 6
    for first in calls[:3]:
        assert any(all(torch.equal(a, b) for a, b in zip(first[:5], again[:5])) for again in calls[3:])


class OneRankMesh:
    """A one-rank stand-in for a ``DeviceMesh``: it splits nothing."""

    mesh_dim_names = ("heliostats", "rays")

    def size(self, dim=None) -> int:
        return 1


@pytest.mark.parametrize("option", ["distributed_setup", "mesh", "checkpoint_dir"])
def test_aim_point_optimizer_refuses_what_is_not_ported(option, tmp_path):
    """Every option is ported and accepted: ``checkpoint_dir`` (``tests/test_torch_checkpointing.py``
    resumes from it), ``distributed_setup`` and ``mesh`` (``tests/test_torch_distributed.py`` runs
    them). What is refused is a mesh in the group-parallel mode, whose ranks run different groups."""
    scenario = _port_scenario(_jax_scenario(), (np.zeros(1), np.zeros(1)))
    arguments = dict(
        scenario=scenario, optimization_configuration=_configuration(1),
        incident_ray_direction=[0.0, 1.0, 0.0, 0.0], target_area_index=0,
        ground_truth=np.ones(BITMAP[::-1]), dni=DNI,
    )
    if option == "checkpoint_dir":
        assert AimPointOptimizer(**arguments, checkpoint_dir=tmp_path).checkpoint_dir == tmp_path
    elif option == "distributed_setup":
        setup = DistributedSetup(False, False, 0, 1, {0: [0]}, {0: [0]})
        assert AimPointOptimizer(**arguments, distributed_setup=setup).distributed_setup is setup
    else:
        mesh = OneRankMesh()
        assert AimPointOptimizer(**arguments, mesh=mesh).mesh is mesh
        group_parallel = DistributedSetup(True, False, 0, 2, {0: [0], 1: []}, {0: [0]})
        with pytest.raises(ValueError, match="group-parallel"):
            AimPointOptimizer(**arguments, mesh=mesh, distributed_setup=group_parallel)


def test_chip_smoke_aim_point_agreement_runs_on_the_cpu():
    """Rehearsal of chip_smoke.py's aim-point agreement phase, CPU against CPU, K = 16 and 32
    and the flat route."""
    results = chip_smoke.check_small_aim_point_against_cpu(torch.device("cpu"))
    assert list(results) == [16, 32, None]

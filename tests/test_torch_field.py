"""The port's field modules against the JAX package's, on a converted synthetic group.

The JAX ``make_synthetic_scenario`` state is carried into the port through
``convert.py``; both packages then compute from the same parameters.
Tolerances: orientations and aligned geometry are fp32 chains of trig and
4x4 products (JAX at ``precision=HIGHEST``), agreeing to ``rtol = 1e-5``
with ``atol = 1e-5`` on unit vectors and ``atol = 1e-4`` on world
coordinates of tens of metres. Motor positions are strokes times an
increment of ~1.5e5 steps per metre, so one fp32 ulp of a stroke is ~1e-3
steps: they get ``atol = 0.05`` steps.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.field import actuators as jax_actuators
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field import kinematics_rigid_body as jax_kinematics
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import group_from_numpy, tower_from_numpy
from artist_tpu_torch.field import actuators
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field import kinematics_rigid_body as kinematics
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.util import constants

UNIT = dict(rtol=1e-5, atol=1e-5)
WORLD = dict(rtol=1e-5, atol=1e-4)
MOTOR = dict(rtol=1e-5, atol=0.05)


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _scenes(actuator_type):
    jax_scenario = jax_synthetic(
        number_of_heliostats=3,
        number_of_surface_points_per_facet=(3, 3),
        number_of_rays=2,
        actuator_type=actuator_type,
    )
    jax_group = jax_scenario.heliostat_groups[0]
    group = group_from_numpy(_as_dict(jax_group), device="cpu")
    tower = tower_from_numpy(_as_dict(jax_scenario.solar_tower), device="cpu")
    return jax_scenario, jax_group, group, tower


@pytest.fixture(scope="module", params=[constants.linear_actuator_key, constants.ideal_actuator_key])
def scenes(request):
    return _scenes(request.param)


def _incident(num, seed):
    rng = np.random.RandomState(seed)
    sun = np.stack([rng.uniform(-0.4, 0.4, num), rng.uniform(0.6, 1.0, num), rng.uniform(-0.6, -0.2, num)], 1)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    return np.concatenate([sun, np.zeros((num, 1))], 1).astype(np.float32)


def test_converted_group_keeps_every_field(scenes):
    _, jax_group, group, _ = scenes
    for field in dataclasses.fields(jax_group):
        ours, theirs = getattr(group, field.name), getattr(jax_group, field.name)
        if isinstance(ours, torch.Tensor):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        else:
            assert tuple(ours) == tuple(theirs) if isinstance(theirs, tuple) else ours == theirs


def test_actuators_round_trip(scenes):
    _, jax_group, group, _ = scenes
    rng = np.random.RandomState(1)
    motors = rng.uniform(1e4, 6e4, size=(3, 2)).astype(np.float32)
    angles = actuators.motor_positions_to_angles(
        group.actuator_type, group.actuator_non_optimizable, group.actuator_optimizable, torch.tensor(motors)
    )
    jax_angles = jax_actuators.motor_positions_to_angles(
        jax_group.actuator_type, jax_group.actuator_non_optimizable, jax_group.actuator_optimizable, jnp.asarray(motors)
    )
    np.testing.assert_allclose(angles.numpy(), np.asarray(jax_angles), **UNIT)
    back = actuators.angles_to_motor_positions(
        group.actuator_type, group.actuator_non_optimizable, group.actuator_optimizable, angles
    )
    jax_back = jax_actuators.angles_to_motor_positions(
        jax_group.actuator_type, jax_group.actuator_non_optimizable, jax_group.actuator_optimizable, jax_angles
    )
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_back), **MOTOR)
    np.testing.assert_allclose(back.numpy(), motors, rtol=1e-3, atol=1.0)


def test_softplus_clamp_matches():
    x = np.array([[-1.0, -0.05], [0.0, 1e-3], [0.15, 0.25], [0.3, 2.0]], np.float32)
    non_opt = np.zeros((4, 7, 2), np.float32)
    non_opt[:, 4:7] = x[:, None, :]
    opt = np.zeros((4, 2, 2), np.float32)
    opt[:, 1] = x
    ours = actuators.physics_informed_linear_parameters(torch.tensor(non_opt), torch.tensor(opt))
    theirs = jax_actuators.physics_informed_linear_parameters(jnp.asarray(non_opt), jnp.asarray(opt))
    for mine, other in zip(ours, theirs):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), rtol=1e-6, atol=1e-7)


def test_forward_and_inverse_kinematics(scenes):
    _, jax_group, group, _ = scenes
    motors = np.random.RandomState(2).uniform(1e4, 5e4, size=(3, 2)).astype(np.float32)
    if group.actuator_type == constants.ideal_actuator_key:
        motors = np.random.RandomState(2).uniform(-1.0, 1.0, size=(3, 2)).astype(np.float32)
    common = (group.actuator_type, group.actuator_non_optimizable, group.actuator_optimizable)
    jax_common = (jax_group.actuator_type, jax_group.actuator_non_optimizable, jax_group.actuator_optimizable)
    ours = kinematics.motor_positions_to_orientations(
        torch.tensor(motors), group.positions, group.translation_deviations, group.rotation_deviations, *common
    )
    theirs = jax_kinematics.motor_positions_to_orientations(
        jnp.asarray(motors), jax_group.positions, jax_group.translation_deviations,
        jax_group.rotation_deviations, *jax_common,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **WORLD)

    normals = _incident(3, 3)
    ours_motor, ours_valid = kinematics.motor_positions_from_normals(
        torch.tensor(normals), group.rotation_deviations, *common, return_validity=True
    )
    # The JAX default: the positions alone.
    torch.testing.assert_close(
        kinematics.motor_positions_from_normals(torch.tensor(normals), group.rotation_deviations, *common),
        ours_motor, rtol=0, atol=0,
    )
    jax_motor, jax_valid = jax_kinematics.motor_positions_from_normals(
        jnp.asarray(normals), jax_group.rotation_deviations, *jax_common, return_validity=True
    )
    tol = MOTOR if group.actuator_type == constants.linear_actuator_key else UNIT
    np.testing.assert_allclose(ours_motor.numpy(), np.asarray(jax_motor), **tol)
    np.testing.assert_array_equal(ours_valid.numpy(), np.asarray(jax_valid))


def test_align_surfaces_with_incident_ray_directions(scenes):
    jax_scenario, jax_group, group, tower = scenes
    indices = np.array([0, 2, 2, 1])
    targets = np.zeros(4, np.int64)
    incident = _incident(4, 4)
    jax_active = jax_hg.gather_active(jax_group, jnp.asarray(indices, jnp.int32))
    active = hg.gather_active(group, torch.tensor(indices))
    aim = get_centers_of_target_areas(tower, torch.tensor(targets))
    jax_aim = jax_centers(jax_scenario.solar_tower, jnp.asarray(targets, jnp.int32))
    np.testing.assert_array_equal(aim.numpy(), np.asarray(jax_aim))

    ours = hg.align_surfaces_with_incident_ray_directions(active, aim, torch.tensor(incident))
    theirs = jax_hg.align_surfaces_with_incident_ray_directions(jax_active, jax_aim, jnp.asarray(incident))
    for mine, other, tol in zip(ours, theirs, (WORLD, UNIT, WORLD, MOTOR)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), **tol)


def test_incident_ray_directions_to_orientations_converges_like_jax(scenes):
    _, jax_group, group, tower = scenes
    incident = _incident(3, 5)
    aim = get_centers_of_target_areas(tower, torch.zeros(3, dtype=torch.long))
    args = (group.positions, group.translation_deviations, group.rotation_deviations,
            group.actuator_type, group.actuator_non_optimizable, group.actuator_optimizable)
    jax_args = (jax_group.positions, jax_group.translation_deviations, jax_group.rotation_deviations,
                jax_group.actuator_type, jax_group.actuator_non_optimizable, jax_group.actuator_optimizable)
    for iterations in (1, 2, 4):
        ours = kinematics.incident_ray_directions_to_orientations(
            torch.tensor(incident), aim, *args, max_num_iterations=iterations
        )
        theirs = jax_kinematics.incident_ray_directions_to_orientations(
            jnp.asarray(incident), jnp.asarray(aim.numpy()), *jax_args,
            max_num_iterations=iterations, warn_invalid=False,
        )
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), **WORLD)
        tol = MOTOR if group.actuator_type == constants.linear_actuator_key else UNIT
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]), **tol)


def test_invalid_motor_positions_warn_once_per_call(caplog):
    _, _, group, tower = _scenes(constants.linear_actuator_key)
    non_opt = group.actuator_non_optimizable.clone()
    non_opt[:, 3] = 1.0  # a one-step motor range: no solution fits
    tight = group.replace(actuator_non_optimizable=non_opt)
    incident = torch.tensor(_incident(3, 6))
    aim = get_centers_of_target_areas(tower, torch.zeros(3, dtype=torch.long))
    args = (aim, tight.positions, tight.translation_deviations, tight.rotation_deviations,
            tight.actuator_type, tight.actuator_non_optimizable, tight.actuator_optimizable)
    with caplog.at_level(logging.WARNING, logger="artist_tpu_torch.field"):
        kinematics.incident_ray_directions_to_orientations(incident, *args)
    warnings = [r for r in caplog.records if "No valid motor position" in r.getMessage()]
    assert len(warnings) == 1 and "[0, 1, 2]" in warnings[0].getMessage()
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="artist_tpu_torch.field"):
        kinematics.incident_ray_directions_to_orientations(incident, *args, warn_invalid=False)
    assert not caplog.records

"""The port's geometry against the JAX package: transforms, rotations, ray hits.

Inputs come from a numpy seed and go through the JAX function and its port
counterpart. Tolerance: both run the same fp32 formulas (JAX with
``precision=HIGHEST`` on every matmul, the port in full fp32), so they agree
to ``rtol = 1e-5, atol = 1e-6`` on unit-scale values; world coordinates of
tens of metres get ``atol = 1e-4`` (a few fp32 ulps at 50 m), bitmap
coordinates of up to 64 px ``atol = 2e-4``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.geometry import rotations as jax_rotations
from artist_tpu.geometry import transforms as jax_transforms
from artist_tpu.raytracing import geometry as jax_geometry
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import tower_from_numpy
from artist_tpu_torch.geometry import rotations, transforms
from artist_tpu_torch.raytracing import geometry

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x)


def _pt(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("name", ["rotate_e", "rotate_n", "rotate_u"])
def test_axis_rotations(name):
    angles = np.random.RandomState(0).uniform(-np.pi, np.pi, size=(3, 5)).astype(np.float32)
    ours = getattr(transforms, name)(_pt(angles)).numpy()
    theirs = _np(getattr(jax_transforms, name)(jnp.asarray(angles)))
    assert ours.shape == (3, 5, 4, 4)
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_translate_enu():
    e, n, u = np.random.RandomState(1).randn(3, 7).astype(np.float32)
    ours = transforms.translate_enu(_pt(e), _pt(n), _pt(u)).numpy()
    theirs = _np(jax_transforms.translate_enu(jnp.asarray(e), jnp.asarray(n), jnp.asarray(u)))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("components", [3, 4])
def test_apply_distortion_rotation(components):
    rng = np.random.RandomState(2)
    e = (2e-3 * rng.randn(2, 3, 5)).astype(np.float32)
    u = (2e-3 * rng.randn(2, 3, 5)).astype(np.float32)
    directions = rng.randn(2, 1, 5, components).astype(np.float32)
    if components == 4:
        directions[..., 3] = 0.0
    ours = transforms.apply_distortion_rotation(_pt(e), _pt(u), _pt(directions)).numpy()
    theirs = _np(
        jax_transforms.apply_distortion_rotation(
            jnp.asarray(e), jnp.asarray(u), jnp.asarray(directions)
        )
    )
    assert ours.shape == (2, 3, 5, components)
    np.testing.assert_allclose(ours, theirs, **TOL)
    if components == 4:
        # Equal to the materialized rotation rotate_e(e) @ rotate_u(u) @ d.
        full = transforms.rotate_e(_pt(e)) @ transforms.rotate_u(_pt(u))
        expected = (full @ _pt(np.broadcast_to(directions, (2, 3, 5, 4)).copy())[..., None])[..., 0]
        np.testing.assert_allclose(ours, expected.numpy(), rtol=1e-5, atol=1e-6)


def test_normalize_has_torch_semantics():
    v = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0], [1e-14, 0.0, 0.0]], np.float32)
    ours = transforms._normalize(_pt(v)).numpy()
    np.testing.assert_allclose(ours, _np(jax_transforms._normalize(jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(ours, torch.nn.functional.normalize(_pt(v), dim=-1).numpy(), **TOL)


def test_canting_rotation_matrices_and_perform_canting():
    rng = np.random.RandomState(3)
    canting = np.zeros((2, 4, 2, 4), np.float32)
    canting[..., 0, :3] = [0.8, 0.0, 0.0] + 5e-3 * rng.randn(2, 4, 3)
    canting[..., 1, :3] = [0.0, 0.6, 0.0] + 5e-3 * rng.randn(2, 4, 3)
    data = rng.randn(2, 4, 6, 4).astype(np.float32)
    np.testing.assert_allclose(
        transforms.canting_rotation_matrices(_pt(canting)).numpy(),
        _np(jax_transforms.canting_rotation_matrices(jnp.asarray(canting))),
        **TOL,
    )
    for inverse in (False, True):
        ours = transforms.perform_canting(_pt(canting), _pt(data), inverse=inverse).numpy()
        theirs = _np(
            jax_transforms.perform_canting(jnp.asarray(canting), jnp.asarray(data), inverse=inverse)
        )
        np.testing.assert_allclose(ours, theirs, **TOL)


def test_decompose_rotations():
    rng = np.random.RandomState(4)
    vectors = np.concatenate([rng.randn(5, 3), np.zeros((5, 1))], axis=1).astype(np.float32)
    target = np.array([0.0, -1.0, 0.0, 0.0], np.float32)
    ours = rotations.decompose_rotations(_pt(vectors), _pt(target))
    theirs = jax_rotations.decompose_rotations(jnp.asarray(vectors), jnp.asarray(target))
    for mine, other in zip(ours, theirs):
        np.testing.assert_allclose(mine.numpy(), _np(other), rtol=1e-5, atol=1e-5)


def test_reflect():
    rng = np.random.RandomState(5)
    incident = rng.randn(3, 1, 4).astype(np.float32)
    normals = rng.randn(3, 7, 4).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    ours = geometry.reflect(_pt(incident), _pt(normals)).numpy()
    theirs = _np(jax_geometry.reflect(jnp.asarray(incident), jnp.asarray(normals)))
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_line_plane_intersections():
    jax_tower = jax_synthetic(number_of_heliostats=3, number_of_surface_points_per_facet=(2, 2)).solar_tower
    tower = tower_from_numpy(
        {f.name: np.asarray(getattr(jax_tower, f.name)) for f in dataclasses.fields(jax_tower)},
        device="cpu",
    )
    rng = np.random.RandomState(6)
    num, rays, points = 3, 4, 9
    origins = np.concatenate(
        [rng.uniform(-10, 10, (num, points, 1)), rng.uniform(20, 40, (num, points, 1)),
         rng.uniform(1, 3, (num, points, 1)), np.ones((num, points, 1))],
        axis=-1,
    ).astype(np.float32)
    # Aim at the receiver (centre (0, -3, 45)) with spread: some rays miss the
    # plane's extent and a few point away from it (back face).
    aim = np.array([0.0, -3.0, 45.0], np.float32) + rng.uniform(-8, 8, (num, rays, points, 3))
    directions3 = aim - origins[:, None, :, :3]
    directions3[0, 0, :3] *= -1.0
    directions3 /= np.linalg.norm(directions3, axis=-1, keepdims=True)
    directions = np.concatenate([directions3, np.zeros((num, rays, points, 1))], -1).astype(np.float32)
    magnitudes = rng.uniform(0.5, 1.5, (num, rays, points)).astype(np.float32)
    targets = np.zeros(num, np.int64)
    resolution = (64, 48)

    ours = geometry.line_plane_intersections(
        _pt(directions), _pt(magnitudes), _pt(origins), tower, torch.tensor(targets), resolution
    )
    theirs = jax_geometry.line_plane_intersections(
        jnp.asarray(directions), jnp.asarray(magnitudes), jnp.asarray(origins), jax_tower,
        jnp.asarray(targets, jnp.int32), resolution,
    )
    for mine, other, atol in zip(ours, theirs, (2e-4, 2e-4, 1e-4, 1e-6)):
        np.testing.assert_allclose(mine.numpy(), _np(other), rtol=1e-5, atol=atol)
    bitmap_e, _, _, intensities = (x.numpy() for x in ours)
    hit = intensities > 0
    assert 0 < hit.sum() < hit.size
    # Invalid rays are zeroed before the e flip and land on e = W - 1.
    assert np.all(bitmap_e[~hit] == resolution[0] - 1)

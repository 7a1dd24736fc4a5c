"""The coordinate conversions: the port against the JAX package.

Every function of ``artist_tpu_torch/geometry/coordinates.py`` on the same
numpy inputs as its counterpart in ``artist_tpu/geometry/coordinates.py``.

Tolerances, each with its reason:

- the homogeneous formats are copies: equal;
- ``normalize_points`` and ``azimuth_elevation_to_enu``: the same fp32
  formula; the sine and cosine of two libraries may differ by an ulp, so
  1e-6 absolute on values of order 1;
- ``convert_wgs84_coordinates_to_local_enu`` is the same float64 numpy in
  both: equal;
- ``bitmap_coordinates_to_target_coordinates``: the same fp32 formula on
  coordinates of order 10-50 m, where a sine or cosine an ulp apart moves a
  cylinder point by ~1e-6 m: 1e-5 m absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.field.solar_tower import SolarTower as JaxSolarTower
from artist_tpu.geometry import coordinates as jax_coordinates
from artist_tpu_torch.convert import tower_from_numpy
from artist_tpu_torch.geometry import coordinates

RNG = np.random.RandomState(21)


def _tower(kinds: str):
    """Two planar areas (10 x 8 m and 6 x 6 m) and two cylindrical ones (radius 2 m,
    opening pi / 2, 5 m high; radius 3 m, opening pi, 4 m high, its axis tilted), or
    only one kind: a JAX tower and its port."""
    areas = dict(
        planar_centers=[[0.0, -3.0, 45.0, 1.0], [20.0, -2.0, 30.0, 1.0]],
        planar_normals=[[0.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]],
        planar_dimensions=[[10.0, 8.0], [6.0, 6.0]],
        cylindrical_centers=[[0.0, -5.0, 30.0, 1.0], [-15.0, -4.0, 25.0, 1.0]],
        cylindrical_axes=[[0.0, 0.0, 1.0, 0.0], [0.0, 0.1, 0.995, 0.0]],
        cylindrical_normals=[[0.0, 1.0, 0.0, 0.0], [0.0, 0.995, -0.1, 0.0]],
        cylindrical_radii=[2.0, 3.0],
        cylindrical_heights=[5.0, 4.0],
        cylindrical_opening_angles=[np.pi / 2, np.pi],
    )
    kept = {"planar": "planar" in kinds, "cylindrical": "cylindrical" in kinds}
    jax_tower = JaxSolarTower(
        **{
            name: jnp.asarray(
                value if kept[name.split("_")[0]] else np.zeros((0,) + np.shape(value)[1:]), jnp.float32
            )
            for name, value in areas.items()
        },
        planar_names=("receiver", "second") if kept["planar"] else (),
        cylindrical_names=("cylinder", "tilted") if kept["cylindrical"] else (),
    )
    tower = tower_from_numpy(
        {f.name: np.asarray(getattr(jax_tower, f.name)) for f in dataclasses.fields(jax_tower)}, device="cpu"
    )
    return jax_tower, tower


def test_homogeneous_formats_match_jax():
    x = RNG.randn(5, 7, 3).astype(np.float32)
    for name in ("convert_3d_points_to_4d_format", "convert_3d_directions_to_4d_format"):
        ours = getattr(coordinates, name)(torch.tensor(x)).numpy()
        theirs = np.asarray(getattr(jax_coordinates, name)(jnp.asarray(x)))
        np.testing.assert_array_equal(ours, theirs)
        with pytest.raises(ValueError):
            getattr(coordinates, name)(torch.zeros(4, 4))
    assert (coordinates.convert_3d_points_to_4d_format(torch.tensor(x))[..., 3] == 1).all()
    assert (coordinates.convert_3d_directions_to_4d_format(torch.tensor(x))[..., 3] == 0).all()


def test_normalize_points_matches_jax():
    x = (RNG.rand(50, 3) * [10.0, -4.0, 300.0]).astype(np.float32)
    ours = coordinates.normalize_points(torch.tensor(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_coordinates.normalize_points(jnp.asarray(x))), rtol=0, atol=1e-6)
    assert (ours > 0).all() and (ours < 1).all()


@pytest.mark.parametrize("degree", [True, False])
def test_azimuth_elevation_to_enu_matches_jax(degree):
    azimuth = RNG.uniform(-400.0, 400.0, (4, 6)).astype(np.float32)
    elevation = RNG.uniform(-10.0, 90.0, (4, 6)).astype(np.float32)
    if not degree:
        azimuth, elevation = np.deg2rad(azimuth), np.deg2rad(elevation)
    ours = coordinates.azimuth_elevation_to_enu(azimuth, elevation, slant_range=2.5, degree=degree).numpy()
    theirs = np.asarray(jax_coordinates.azimuth_elevation_to_enu(azimuth, elevation, slant_range=2.5, degree=degree))
    assert ours.shape == (4, 6, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * 2.5)
    # Azimuth 0 looks south, 90 degrees east.
    south, east = coordinates.azimuth_elevation_to_enu(np.array([0.0, 90.0]), np.array([0.0, 0.0])).numpy()
    np.testing.assert_allclose(south, [0.0, -1.0, 0.0], atol=1e-7)
    np.testing.assert_allclose(east, [1.0, 0.0, 0.0], atol=1e-7)
    with pytest.raises(ValueError):
        coordinates.azimuth_elevation_to_enu(np.zeros(3), np.zeros(2))


def test_wgs84_to_local_enu_matches_jax():
    reference = np.array([50.91342112259258, 6.387824755874856, 87.0])
    points = reference + np.stack(
        [RNG.uniform(-2e-3, 2e-3, 20), RNG.uniform(-3e-3, 3e-3, 20), RNG.uniform(-5.0, 60.0, 20)], axis=1
    )
    ours = coordinates.convert_wgs84_coordinates_to_local_enu(points, reference)
    np.testing.assert_array_equal(ours, jax_coordinates.convert_wgs84_coordinates_to_local_enu(points, reference))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(coordinates.convert_wgs84_coordinates_to_local_enu(reference[None], reference), 0)


@pytest.mark.parametrize("kinds", ["planar", "cylindrical", "planar+cylindrical"])
def test_bitmap_to_target_coordinates_matches_jax(kinds):
    jax_tower, tower = _tower(kinds)
    count = 40
    pixels = (RNG.rand(count, 2) * [64.0, 48.0] - 0.5).astype(np.float32)
    pixels[:4] = [[-0.5, -0.5], [63.5, 47.5], [31.5, 23.5], [0.0, 47.0]]  # the corners and the centre
    areas = tower.number_of_target_areas
    targets = (np.arange(count) % areas).astype(np.int32)
    ours = coordinates.bitmap_coordinates_to_target_coordinates(
        torch.tensor(pixels), (64, 48), tower, torch.tensor(targets, dtype=torch.long)
    ).numpy()
    theirs = np.asarray(
        jax_coordinates.bitmap_coordinates_to_target_coordinates(
            jnp.asarray(pixels), (64, 48), jax_tower, jnp.asarray(targets)
        )
    )
    assert ours.shape == (count, 4) and (ours[:, 3] == 1).all()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    # The centre pixel of a planar map is the area's centre; a cylinder's lies on its
    # normal at its radius.
    planar = tower.number_of_planar_target_areas
    centre = ours[2]
    if targets[2] < planar:
        np.testing.assert_allclose(centre[:3], tower.planar_centers[targets[2], :3].numpy(), atol=1e-5)
    else:
        c = targets[2] - planar
        expected = tower.cylindrical_centers[c, :3] + tower.cylindrical_radii[c] * tower.cylindrical_normals[c, :3]
        np.testing.assert_allclose(centre[:3], expected.numpy(), atol=1e-5)

"""Cylindrical target areas: the port's intersection and trace against the JAX package.

Towers are built as ``tests/raytracing/test_geometry.py`` builds them: a
cylinder with a vertical axis whose normal points north toward the field
(the PAINT Juelich convention), beside a planar receiver. Tolerances:

- ``line_cylinder_intersections`` on hand-made rays (hits, rays parallel to
  the axis, rays pointing away, hits above the patch and beside its opening
  angle): the same fp32 formulas, so 1e-5 relative (1e-5 of each output's
  largest entry absolute), and exactly 0 wherever JAX masks a ray;
- ``trace_rays`` on a cylinder-only and on a mixed tower, from the same
  aligned surfaces and sun distortions: the flux to 2e-4 of its peak, the
  factors, ray counts over the same total, to 1e-6. On a plane the two
  packages' traces agree to 1e-4 of the peak (``test_torch_render.py``). On a
  cylinder a hit's distance solves a quadratic that cancels ``b^2`` against
  ``4ac``, so the 1.2e-7 by which the packages' distortion rotations round a
  direction moves a hit by up to 2.5e-4 px here (2e-5 px on a plane), and the
  flux differs by up to 1.3e-4 of its peak (measured; the JAX package's own
  two splat routes agree to 1e-7 of it on the same rays).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import SolarTower as JaxSolarTower
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.raytracing import geometry as jax_geometry
from artist_tpu.raytracing import render as jax_render
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import tower_from_numpy
from artist_tpu_torch.raytracing import geometry, render

HELIOSTATS = 3
POINTS = (5, 5)
RAYS = 4
BITMAP = (48, 40)


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _tower(planar: bool, cylinder_center=(0.0, -10.0, 0.0, 1.0), radius=2.0, height=4.0, opening=np.pi):
    """A planar area at (0, 10, 0) facing south (4 x 4 m) if asked, and a
    cylinder facing north."""
    return JaxSolarTower(
        planar_centers=jnp.asarray([[0.0, 10.0, 0.0, 1.0]] if planar else np.zeros((0, 4)), jnp.float32),
        planar_normals=jnp.asarray([[0.0, -1.0, 0.0, 0.0]] if planar else np.zeros((0, 4)), jnp.float32),
        planar_dimensions=jnp.asarray([[4.0, 4.0]] if planar else np.zeros((0, 2)), jnp.float32),
        cylindrical_centers=jnp.asarray([cylinder_center], jnp.float32),
        cylindrical_axes=jnp.asarray([[0.0, 0.0, 1.0, 0.0]], jnp.float32),
        cylindrical_normals=jnp.asarray([[0.0, 1.0, 0.0, 0.0]], jnp.float32),
        cylindrical_radii=jnp.asarray([radius], jnp.float32),
        cylindrical_heights=jnp.asarray([height], jnp.float32),
        cylindrical_opening_angles=jnp.asarray([opening], jnp.float32),
        planar_names=("plane",) if planar else (),
        cylindrical_names=("cylinder",),
    )


def _hand_made_rays():
    """Two heliostats' ray bundles ``[2, 5, 6, 4]`` from origins ``[2, 6, 4]`` north of
    the cylinder (centre y = -10, radius 2, 4 m high, its north half): ray 0
    straight south (hits), 1 parallel to the axis, 2 north (away), 3 steeply up
    (passes above the patch), 4 south-west past the patch's western edge;
    origins spread east-west and up-down, the second heliostat farther north."""
    origins = np.zeros((2, 6, 4), np.float32)
    origins[..., 0] = np.linspace(-1.5, 1.5, 6)
    origins[..., 2] = np.linspace(-1.0, 1.0, 6)
    origins[1, :, 1] = 15.0
    origins[..., 3] = 1.0
    directions = np.array(
        [[0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, -0.3, 1.0], [-1.0, -0.5, 0.0]],
        np.float32,
    )
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    rays = np.zeros((2, 5, 6, 4), np.float32)
    rays[..., :3] = directions[None, :, None, :]
    rng = np.random.RandomState(12)
    rays[..., :3] += rng.normal(0.0, 1e-3, rays[..., :3].shape)
    rays[..., :3] /= np.linalg.norm(rays[..., :3], axis=-1, keepdims=True)
    rays[:, 1, :, :3] = [0.0, 0.0, 1.0]  # exactly parallel to the axis
    return rays, origins


def test_line_cylinder_intersections_match_jax():
    jax_tower = _tower(planar=True)
    tower = tower_from_numpy(_as_dict(jax_tower), device="cpu")
    rays, origins = _hand_made_rays()
    magnitudes = np.full(rays.shape[:3], 0.7, np.float32)
    targets = np.zeros(2, np.int32)  # cylinder-local
    theirs = [
        np.asarray(x) for x in jax_geometry.line_cylinder_intersections(
            jnp.asarray(rays), jnp.asarray(magnitudes), jnp.asarray(origins), jax_tower, jnp.asarray(targets), BITMAP
        )
    ]
    ours = [
        x.numpy() for x in geometry.line_cylinder_intersections(
            torch.tensor(rays), torch.tensor(magnitudes), torch.tensor(origins), tower,
            torch.tensor(targets, dtype=torch.long), BITMAP,
        )
    ]
    hits = theirs[3] > 0
    # South-pointing rays hit; rays along the axis, away from it, above the patch or
    # beside its opening do not.
    assert hits[:, 0].all() and not hits[:, 1:].any()
    for mine, other in zip(ours, theirs):
        np.testing.assert_allclose(mine, other, rtol=1e-5, atol=1e-5 * np.abs(other).max())
        assert (mine[~hits] == 0).all()
    # The first heliostat's rays meet the surface about 8 m south (radius 2,
    # centre 10 m), up to their 1e-3 rad of scatter.
    np.testing.assert_allclose(ours[2][0, 0], 10.0 - np.sqrt(4 - origins[0, :, 0] ** 2), rtol=0, atol=2e-2)


def _aligned(jax_scenario, targets: np.ndarray):
    """JAX's aligned surfaces of the synthetic field aiming at ``targets``: numpy
    points and normals ``[H, P, 4]`` and incident directions ``[H, 4]``."""
    group = jax_scenario.heliostat_groups[0]
    incident = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0, 0.0], jnp.float32), (HELIOSTATS, 4))
    active = jax_hg.gather_active(group, jnp.arange(HELIOSTATS))
    aim = jax_centers(jax_scenario.solar_tower, jnp.asarray(targets))
    points, normals = jax_hg.align_surfaces_with_incident_ray_directions(active, aim, incident)[:2]
    return np.asarray(points), np.asarray(normals), np.asarray(incident)


@pytest.mark.parametrize("kind", ["cylinder_only", "mixed"])
@pytest.mark.parametrize("ray_chunk", [None, 2], ids=["whole", "chunk2"])
def test_trace_rays_on_cylinders_matches_jax(kind, ray_chunk):
    """The synthetic field (rows north of the tower) onto a cylinder of radius 10 m
    at 30 m, 3 m high with an opening of 0.4 rad (a 4 m arc), so the spots spill
    over the patch's edges but no ray grazes the surface (where the distance's
    derivative by the direction grows without bound, and fp32 rounding of the
    direction moves a hit by up to 1e-3 px: a 2 m cylinder's silhouette); on the
    mixed tower heliostats 0 and 2 aim at a 10 x 10 m planar receiver at 45 m
    and heliostat 1 at the cylinder."""
    jax_scenario = jax_synthetic(number_of_heliostats=HELIOSTATS, number_of_surface_points_per_facet=POINTS,
                                 number_of_rays=RAYS)
    planar = jax_scenario.solar_tower
    cylinder = _tower(planar=False, cylinder_center=(0.0, -13.0, 30.0, 1.0), radius=10.0, height=3.0, opening=0.4)
    if kind == "mixed":
        jax_tower = dataclasses.replace(
            cylinder,
            planar_centers=planar.planar_centers,
            planar_normals=planar.planar_normals,
            planar_dimensions=planar.planar_dimensions,
            planar_names=planar.planar_names,
        )
        targets = np.array([0, 1, 0], np.int32)
    else:
        jax_tower, targets = cylinder, np.zeros(HELIOSTATS, np.int32)
    jax_scenario = dataclasses.replace(jax_scenario, solar_tower=jax_tower)
    points, normals, incident = _aligned(jax_scenario, targets)
    rng = np.random.RandomState(13)
    # Wider than the sun's 2.1 mrad: the spots spill over the patch's edges.
    du, de = rng.normal(0.0, 1e-2, (2, HELIOSTATS, RAYS, points.shape[1])).astype(np.float32)
    config = dict(bitmap_resolution=BITMAP, ray_chunk=ray_chunk)
    theirs = [
        np.asarray(x) for x in jax_render.trace_rays(
            jax_tower, jnp.asarray(points), jnp.asarray(normals), jnp.asarray(incident), jnp.asarray(targets),
            jnp.asarray(du), jnp.asarray(de), config=jax_render.RenderConfig(**config),
        )
    ]
    tower = tower_from_numpy(_as_dict(jax_tower), device="cpu")
    aligned_points = torch.tensor(points, requires_grad=True)
    ours = render.trace_rays(
        tower, aligned_points, torch.tensor(normals), torch.tensor(incident),
        torch.tensor(targets, dtype=torch.long), torch.tensor(du), torch.tensor(de),
        config=render.RenderConfig(**config),
    )
    flux = ours[0].detach().numpy()
    assert flux.shape == (HELIOSTATS, BITMAP[1], BITMAP[0])
    np.testing.assert_allclose(flux, theirs[0], rtol=0, atol=2e-4 * theirs[0].max())
    for mine, other in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(mine.numpy(), other, rtol=1e-6, atol=0)
    # Every map is lit, and some rays miss the cylinder's patch.
    assert (flux.sum(axis=(1, 2)) > 0).all()
    assert 0 < theirs[1].min() < 1
    # The mixed tower's unselected branch leaks nothing into the gradient.
    weights = torch.tensor(rng.rand(*flux.shape).astype(np.float32))
    torch.sum(ours[0] * weights).backward()
    assert torch.isfinite(aligned_points.grad).all() and (aligned_points.grad != 0).any()

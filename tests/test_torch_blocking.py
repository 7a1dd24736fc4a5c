"""Field-wide blocking: the port against the JAX package's candidate-compacted Pallas path.

The JAX side runs ``blocking_method="pallas"`` (the compacted route, in
interpret mode on the CPU); its CPU default is the flat route, which
``test_torch_blocking_flat.py`` holds the port's flat route against. The port's
side runs the plain PyTorch versions of the CUDA kernels, because every
tensor here lies on the CPU. All inputs come from numpy seeds.

Tolerances, each with its reason:

- the grazing scene (softness 6, gates active): the mask to 1e-6 and each
  gradient to ``5e-6 x`` its largest entry, JAX's own bound for its Pallas
  kernels against XLA autodiff (``tests/kernels/test_blocking_pallas.py``);
- the dense-row field (softness 1000): flux to ``1e-4`` of its peak, as the
  unblocked render (fp32 geometry, sums in other orders), and the factors,
  which are ray counts, exactly;
- the plain backward against autograd through the plain forward, in float64:
  ``1e-10`` relative to each cotangent's largest entry (the two differ by
  float64 rounding only; the clamped exponentials never engage there).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.raytracing import blocking as jax_blocking
from artist_tpu.raytracing import render as jax_render
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.kernels import blocking as kernels
from artist_tpu_torch.raytracing import blocking, render

HELIOSTATS = 9  # three rows of three
POINTS = (5, 5)
RAYS = 4
BITMAP = (32, 32)


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _unit_square(y: float):
    corner_0 = np.array([0.0, y, 0.0, 1.0])
    span_u = np.array([1.0, 0.0, 0.0, 0.0])
    span_v = np.array([0.0, 0.0, 1.0, 0.0])
    corners = np.stack([corner_0, corner_0 + span_u, corner_0 + span_u + span_v, corner_0 + span_v])
    return corners, np.stack([span_u, span_v]), np.array([0.0, -1.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def grazing_scene():
    """Rays straddling the edges of two unit squares, soft gates active (softness 6);
    the scene of ``tests/kernels/test_blocking_pallas.py`` with numpy noise."""
    heliostats, rays, points = 2, 3, 4
    origins = np.zeros((heliostats, points, 4))
    origins[..., 3] = 1.0
    origins[:, :, 0] = np.linspace(-0.6, 0.9, points)
    directions3 = np.tile([[0.05, 1.0, 0.02]], (heliostats * rays * points, 1)).reshape(heliostats, rays, points, 3)
    directions3 = directions3 + 0.08 * np.random.RandomState(5).standard_normal(directions3.shape)
    directions3 /= np.linalg.norm(directions3, axis=-1, keepdims=True)
    directions = np.concatenate([directions3, np.zeros(directions3.shape[:-1] + (1,))], axis=-1)
    parts = list(zip(_unit_square(1.0), _unit_square(2.5)))
    corners, spans, normals = (np.stack(p) for p in parts)
    t_target = np.full((heliostats, rays, points), 10.0)
    own = np.array([-1, -1])
    arrays = [x.astype(np.float32) for x in (origins, directions, corners, spans, normals, t_target)]
    return arrays, own


def test_grazing_scene_mask_and_gradients_match_jax(grazing_scene):
    (origins, directions, corners, spans, normals, t_target), own = grazing_scene
    weights = np.linspace(0.5, 1.5, origins.shape[1]).astype(np.float32)

    def jax_loss(o, d, c, s, n):
        mask = jax_blocking.soft_ray_blocking_mask(
            o, d, c, s, n, intersection_distances_target=jnp.asarray(t_target),
            ray_primitive_indices=jnp.asarray(own), softness=6.0, method="pallas", max_candidates=16,
        )
        return jnp.sum(mask * weights), mask

    jax_args = [jnp.asarray(x) for x in (origins, directions, corners, spans, normals)]
    (_, jax_mask), jax_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*jax_args)

    args = [torch.tensor(x, requires_grad=True) for x in (origins, directions, corners, spans, normals)]
    mask = blocking.soft_ray_blocking_mask(
        *args, intersection_distances_target=torch.tensor(t_target),
        ray_primitive_indices=torch.tensor(own), softness=6.0, max_candidates=16,
    )
    torch.sum(mask * torch.tensor(weights)).backward()

    assert float(mask.detach().mean()) > 0.1  # the scene blocks
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(jax_mask), rtol=0, atol=1e-6)
    for name, arg, expected in zip(("origins", "directions", "corners", "spans", "normals"), args, jax_grads):
        expected = np.asarray(expected)
        scale = np.abs(expected).max()
        assert scale > 1e-3, f"vacuous gradient for {name}"
        np.testing.assert_allclose(arg.grad.numpy(), expected, rtol=0, atol=5e-6 * scale, err_msg=name)


def _random_sigma_inputs(dtype, seed=0, heliostats=3, rays=2, points=24, candidates=5):
    """Rays and candidate rectangles that cross at moderate softness, one padded
    candidate slot per heliostat and one ray gated off with ``t_target = -1e30``."""
    rng = np.random.RandomState(seed)
    origins = np.zeros((heliostats, points, 4))
    origins[..., :3] = rng.uniform(-1.0, 1.0, (heliostats, points, 3))
    origins[..., 3] = 1.0
    directions = np.zeros((heliostats, rays * points, 4))
    directions[..., :3] = [0.0, 1.0, 0.0] + 0.3 * rng.standard_normal((heliostats, rays * points, 3))
    directions[..., :3] /= np.linalg.norm(directions[..., :3], axis=-1, keepdims=True)
    t_target = rng.uniform(1.0, 6.0, (heliostats, rays * points))
    t_target[:, 0] = -1e30
    corners = np.zeros((heliostats * candidates, 4, 4))
    c0 = np.stack([rng.uniform(-1.5, 0.0, heliostats * candidates), rng.uniform(1.0, 4.0, heliostats * candidates),
                   rng.uniform(-1.5, 0.0, heliostats * candidates)], axis=1)
    span_u = np.stack([rng.uniform(1.0, 2.0, len(c0)), 0.2 * rng.standard_normal(len(c0)), np.zeros(len(c0))], axis=1)
    span_v = np.stack([0.1 * rng.standard_normal(len(c0)), 0.2 * rng.standard_normal(len(c0)),
                       rng.uniform(1.0, 2.0, len(c0))], axis=1)
    corners[:, 0, :3], corners[:, 1, :3], corners[:, 3, :3] = c0, c0 + span_u, c0 + span_v
    corners[..., 3] = 1.0
    spans = np.stack([corners[:, 1] - corners[:, 0], corners[:, 3] - corners[:, 0]], axis=1)
    n3 = np.cross(spans[:, 0, :3], spans[:, 1, :3])
    normals = np.concatenate([n3 / np.linalg.norm(n3, axis=-1, keepdims=True), np.zeros((len(n3), 1))], axis=1)
    table = blocking.primitive_table(*(torch.tensor(x, dtype=dtype) for x in (corners, spans, normals)))
    columns = table.reshape(heliostats, candidates, -1).contiguous()
    keep = torch.ones((heliostats, candidates), dtype=dtype)
    keep[:, -1] = 0.0
    gbar = torch.tensor(rng.standard_normal((heliostats, rays * points)), dtype=dtype)
    rays_in = [torch.tensor(x, dtype=dtype) for x in (origins, directions, t_target)]
    return (*rays_in, columns, keep), gbar


def test_plain_backward_matches_autograd_in_float64():
    inputs, gbar = _random_sigma_inputs(torch.float64)
    parameters = (6.0, 0.05, 1e-12)
    origins, directions, t_target, columns, keep = inputs
    leaves = [x.clone().requires_grad_(True) for x in (origins, directions, columns)]
    sigma = kernels.sigma_forward_plain(leaves[0], leaves[1], t_target, leaves[2], keep, *parameters)
    assert float(sigma.detach().max()) > 0.1  # pairs actually overlap
    assert (sigma[:, 0] == 0).all()  # the gated-off ray
    torch.sum(sigma * gbar).backward()
    derived = kernels.sigma_backward_plain(*inputs, gbar, *parameters)
    for name, leaf, mine in zip(("origins", "directions", "columns"), leaves, derived):
        scale = float(leaf.grad.abs().max())
        assert scale > 1e-3, name
        torch.testing.assert_close(mine, leaf.grad, rtol=0, atol=1e-10 * scale, msg=name)
    grad_origins, grad_directions, grad_columns = derived
    assert (grad_columns[:, -1] == 0).all()  # the padded candidate slot
    assert (grad_directions[:, 0] == 0).all()  # the gated-off ray
    assert (grad_directions[..., 3] == 0).all() and (grad_origins[..., 3] == 0).all()


def test_sigma_operator_dispatches_and_checks_its_inputs():
    """On the CPU the operator is the plain version; malformed inputs raise."""
    inputs, gbar = _random_sigma_inputs(torch.float32)
    parameters = (1000.0, 0.05, 1e-12)
    expected = kernels.sigma_forward_plain(*inputs, *parameters)
    torch.testing.assert_close(kernels.blocking_sigma(*inputs, *parameters), expected, rtol=0, atol=0)
    origins, directions, t_target, columns, keep = inputs
    with pytest.raises(ValueError):
        kernels.blocking_sigma(origins, directions[:, :-1], t_target[:, :-1], columns, keep, *parameters)
    with pytest.raises(ValueError):
        kernels.blocking_sigma(origins, directions, t_target, columns[..., :15].contiguous(), keep, *parameters)
    with pytest.raises(TypeError):
        kernels.blocking_sigma(*(x.half() for x in inputs), *parameters)


@pytest.fixture(scope="module")
def dense_rows():
    """The synthetic field with rows 3 m apart (the flagship's are 12 m apart and block nothing),
    aligned to the target's centre, in both packages, with the same numpy distortions."""
    jax_scenario = jax_synthetic(
        number_of_heliostats=HELIOSTATS, number_of_surface_points_per_facet=POINTS, number_of_rays=RAYS
    )
    group = jax_scenario.heliostat_groups[0]
    positions = chip_smoke.row_positions(HELIOSTATS, chip_smoke.DENSE_ROW_SPACING)
    jax_scenario.heliostat_groups[0] = group.replace(positions=jnp.asarray(positions))
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position,
        _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources],
        [_as_dict(g) for g in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names,
        device="cpu",
    )
    rng = np.random.RandomState(3)
    points = 4 * POINTS[0] * POINTS[1]
    du, de = rng.normal(0.0, 2e-3, (2, HELIOSTATS, RAYS, points)).astype(np.float32)

    group = jax_scenario.heliostat_groups[0]
    targets = jnp.zeros(HELIOSTATS, jnp.int32)
    incident = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0, 0.0], jnp.float32), (HELIOSTATS, 4))
    active = jax_hg.gather_active(group, jnp.arange(HELIOSTATS))
    jax_points, jax_normals = jax_hg.align_surfaces_with_incident_ray_directions(
        active, jax_centers(jax_scenario.solar_tower, targets), incident
    )[:2]
    jax_side = (jax_scenario, jax_points, jax_normals, targets, incident)

    group = scenario.heliostat_groups[0]
    port_targets = torch.zeros(HELIOSTATS, dtype=torch.long)
    port_incident = torch.tensor([0.0, 1.0, 0.0, 0.0]).expand(HELIOSTATS, 4)
    points_, normals_ = hg.align_surfaces_with_incident_ray_directions(
        hg.gather_active(group, torch.arange(HELIOSTATS)),
        get_centers_of_target_areas(scenario.solar_tower, port_targets),
        port_incident,
    )[:2]
    port_side = (scenario, points_, normals_, port_targets, port_incident)
    return jax_side, port_side, du, de


def test_blocking_primitives_match_jax(dense_rows):
    (jax_scenario, jax_points, _, _, _), (scenario, points, _, _, _), _, _ = dense_rows
    for ours, theirs in zip(
        blocking.create_blocking_primitives_rectangles_by_index(points),
        jax_blocking.create_blocking_primitives_rectangles_by_index(jax_points),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)
    flat = scenario.heliostat_groups[0].surface_points
    jax_flat = jax_scenario.heliostat_groups[0].surface_points
    for ours, theirs in zip(
        blocking.create_blocking_primitives_rectangle(flat, points),
        jax_blocking.create_blocking_primitives_rectangle(jax_flat, jax_points),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)


def _jax_rays(jax_side, du, de):
    """JAX's ray directions and target distances of the dense-row field, ``[M, R, P, 4]`` and ``[M, R, P]``."""
    from artist_tpu.geometry.transforms import apply_distortion_rotation
    from artist_tpu.raytracing import geometry

    jax_scenario, points, normals, targets, incident = jax_side
    preferred = geometry.reflect(incident[:, None, :], normals)
    directions = apply_distortion_rotation(e=jnp.asarray(de), u=jnp.asarray(du), directions=preferred[:, None])
    distances = geometry.line_plane_intersections(
        directions, 1.0, points, jax_scenario.solar_tower, targets, BITMAP
    )[2]
    return directions, distances


@pytest.mark.parametrize("k", [4, 16])
def test_select_blocking_candidates_matches_jax(dense_rows, k):
    """Candidate sets per heliostat (sorted, valid slots only): top-k orders ties differently."""
    jax_side, _, du, de = dense_rows
    directions, distances = _jax_rays(jax_side, du, de)
    points = jax_side[1]
    corners = jax_blocking.create_blocking_primitives_rectangles_by_index(points)[0]
    own = np.arange(HELIOSTATS)
    theirs = jax_blocking.select_blocking_candidates(points, directions, corners, jnp.asarray(own), distances, k)
    ours = blocking.select_blocking_candidates(
        *(torch.tensor(np.asarray(x)) for x in (points, directions, corners)),
        torch.tensor(own), torch.tensor(np.asarray(distances)), k,
    )
    assert ours[0].shape == (HELIOSTATS, min(k, HELIOSTATS))  # K is clamped to the field
    counts = []
    for m in range(HELIOSTATS):
        mine = sorted(ours[0][m][ours[1][m]].tolist())
        other = sorted(np.asarray(theirs[0][m])[np.asarray(theirs[1][m])].tolist())
        assert mine == other, m
        assert m not in mine
        counts.append(len(mine))
    assert max(counts) > 0


@pytest.mark.parametrize("ray_chunk", [None, 2], ids=["whole", "chunk2"])
def test_trace_rays_with_blocking_matches_jax(dense_rows, ray_chunk):
    (jax_scenario, jax_points, jax_normals, jax_targets, jax_incident), port, du, de = dense_rows
    scenario, points, normals, targets, incident = port
    jax_primitives = jax_blocking.create_blocking_primitives_rectangles_by_index(jax_points)
    theirs = jax_render.trace_rays(
        jax_scenario.solar_tower, jax_points, jax_normals, jax_incident, jax_targets,
        jnp.asarray(du), jnp.asarray(de), blocking_primitives=jax_primitives,
        ray_primitive_indices=jnp.arange(HELIOSTATS),
        config=jax_render.RenderConfig(
            bitmap_resolution=BITMAP, ray_chunk=ray_chunk, blocking_active=True,
            blocking_method="pallas", blocking_candidates=16,
        ),
    )
    ours = render.trace_rays(
        scenario.solar_tower, points, normals, incident, targets, torch.tensor(du), torch.tensor(de),
        blocking_primitives=blocking.create_blocking_primitives_rectangles_by_index(points),
        ray_primitive_indices=torch.arange(HELIOSTATS),
        config=render.RenderConfig(bitmap_resolution=BITMAP, ray_chunk=ray_chunk, blocking_active=True),
    )
    flux, flux_jax = ours[0].numpy(), np.asarray(theirs[0])
    assert flux.sum() > 0
    np.testing.assert_allclose(flux, flux_jax, rtol=0, atol=1e-4 * flux_jax.max())
    for mine, other in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), rtol=1e-6, atol=0)
    assert float(ours[3].min()) < 1.0  # some heliostat is blocked
    assert float(ours[3].max()) == 1.0  # the front row is not


def test_checkpointed_chunks_save_sigma(dense_rows, monkeypatch):
    """Launch counts chip_smoke.py asserts with blocking on: per chunk one sigma forward
    (its output is saved, so the recompute does not run it), one sigma backward, two
    splat forwards (the recompute reruns it) and one splat backward."""
    _, (scenario, points, normals, targets, incident), du, de = dense_rows
    splat_module = sys.modules["artist_tpu_torch.kernels.splat"]
    calls = dict.fromkeys(("sigma_forward", "sigma_backward", "splat_forward", "splat_backward"), 0)

    def counted(module, name, key):
        original = getattr(module, name)

        def wrapper(*args):
            calls[key] += 1
            return original(*args)

        monkeypatch.setattr(module, name, wrapper)

    counted(kernels, "sigma_forward_plain", "sigma_forward")
    counted(kernels, "sigma_backward_plain", "sigma_backward")
    counted(splat_module, "splat_forward_plain", "splat_forward")
    counted(splat_module, "splat_backward_plain", "splat_backward")
    leaf = points.detach().clone().requires_grad_(True)
    flux = render.trace_rays(
        scenario.solar_tower, leaf, normals.detach(), incident, targets, torch.tensor(du), torch.tensor(de),
        blocking_primitives=blocking.create_blocking_primitives_rectangles_by_index(leaf),
        ray_primitive_indices=torch.arange(HELIOSTATS),
        config=render.RenderConfig(bitmap_resolution=BITMAP, ray_chunk=1, blocking_active=True),
    )[0]
    assert calls["sigma_forward"] == RAYS
    flux.square().sum().backward()
    assert calls == {"sigma_forward": RAYS, "sigma_backward": RAYS, "splat_forward": 2 * RAYS, "splat_backward": RAYS}
    assert float(leaf.grad.abs().max()) > 0

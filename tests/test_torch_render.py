"""The slice as a whole: the port's differentiable render step against the JAX package's.

The JAX ``make_synthetic_scenario`` goes through ``convert.py`` into the port;
the same numpy sun distortions are injected into both. The port's side is
the step that ``chip_smoke.py`` drives on the card, at a small size here.
Tolerances: flux sums fp32 deposits in other orders (JAX's one-hot matmul or
scatter against the port's 4-tap scatter) after fp32 geometry chains, so
bitmaps agree to ``1e-4`` of their peak; factors are ray counts and agree
exactly; the loss to ``rtol = 1e-4`` and its control-point gradient to
``1e-3`` of its largest entry.

The gradient is compared under a ground truth of ones on the spot and zeros
off it. Under the step's all-ones ground truth the KL gradient at a pixel is
``-p / q``: pixels at the spot's rim hold a single deposit of a ray whose
fractional offset is ~1e-5 px, which the two packages' fp32 geometry
rounds differently by tens of percent, and ``1 / q`` carries that into the
gradient. The loss itself stays well conditioned and is compared under the
all-ones ground truth too.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.nurbs import create_nurbs_evaluation_grid as jax_grid
from artist_tpu.nurbs import evaluate_nurbs_surfaces as jax_nurbs
from artist_tpu.optim import losses as jax_losses
from artist_tpu.raytracing import render as jax_render
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.optim import losses
from artist_tpu_torch.raytracing import render
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario

HELIOSTATS = 3
POINTS = (5, 5)
RAYS = 4
BITMAP = (32, 32)
REPO = Path(__file__).resolve().parent.parent


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def scenarios():
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
    rng = np.random.RandomState(11)
    points = 4 * POINTS[0] * POINTS[1]
    # Wider than the sun's 2.1 mrad so the spot spreads over the 32 x 32 bitmap.
    du = rng.normal(0.0, 1e-2, (HELIOSTATS, RAYS, points)).astype(np.float32)
    de = rng.normal(0.0, 1e-2, (HELIOSTATS, RAYS, points)).astype(np.float32)
    return jax_scenario, scenario, du, de


def _jax_step(jax_scenario, du, de, ray_chunk, method, ground_truth=None):
    """bench.py's flagship step, built from the JAX package at this size."""
    group = jax_scenario.heliostat_groups[0]
    tower = jax_scenario.solar_tower
    num = group.number_of_heliostats
    indices = jnp.arange(num, dtype=jnp.int32)
    targets = jnp.zeros(num, jnp.int32)
    incident = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0, 0.0], jnp.float32), (num, 4))
    aim = jax_centers(tower, targets)
    config = jax_render.RenderConfig(bitmap_resolution=BITMAP, ray_chunk=ray_chunk, splat_method=method)

    def render_fn(control_points):
        active = jax_hg.gather_active(group.replace(nurbs_control_points=control_points), indices)
        points, normals = jax_nurbs(
            active.nurbs_control_points, group.nurbs_degrees, jax_grid(POINTS),
            canting=active.canting, facet_translations=active.facet_translations,
        )
        active = active.replace(
            surface_points=points.reshape(num, -1, 4), surface_normals=normals.reshape(num, -1, 4)
        )
        aligned_points, aligned_normals = jax_hg.align_surfaces_with_incident_ray_directions(
            active, aim, incident
        )[:2]
        return jax_render.trace_rays(
            tower, aligned_points, aligned_normals, incident, targets,
            jnp.asarray(du), jnp.asarray(de), config=config,
        )

    def loss_fn(control_points):
        flux = render_fn(control_points)[0]
        truth = jnp.ones((num, BITMAP[1], BITMAP[0])) if ground_truth is None else jnp.asarray(ground_truth)
        return jnp.sum(jax_losses.kl_divergence_loss(flux, truth)) / num

    return render_fn, loss_fn, group.nurbs_control_points


def _port_inputs(scenario, du, de, ray_chunk):
    return chip_smoke.step_inputs(scenario, torch.tensor(du), torch.tensor(de), POINTS, BITMAP, ray_chunk)


@pytest.mark.parametrize("method", ["scatter", "pallas_fp32"])
@pytest.mark.parametrize("ray_chunk", [None, 2], ids=["whole", "chunk2"])
def test_trace_rays_matches_jax(scenarios, ray_chunk, method):
    jax_scenario, scenario, du, de = scenarios
    render_fn, _, jax_cp = _jax_step(jax_scenario, du, de, ray_chunk, method)
    theirs = [np.asarray(x) for x in render_fn(jax_cp)]
    inputs = _port_inputs(scenario, du, de, ray_chunk)
    with torch.no_grad():
        ours = [x.numpy() for x in chip_smoke.render(scenario.heliostat_groups[0].nurbs_control_points, inputs)]
    flux, flux_jax = ours[0], theirs[0]
    assert flux.shape == (HELIOSTATS, BITMAP[1], BITMAP[0])
    assert flux.sum() > 0 and np.count_nonzero(flux) > 100
    np.testing.assert_allclose(flux, flux_jax, rtol=0, atol=1e-4 * flux_jax.max())
    for mine, other in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(mine, other, rtol=1e-6, atol=0)
    # A few rays miss the bitmap.
    assert ours[1].min() < 1 and np.all(ours[1] > 0.9)
    np.testing.assert_array_equal(ours[3], np.ones(HELIOSTATS))


@pytest.mark.parametrize("ray_chunk", [None, 2], ids=["whole", "chunk2"])
def test_loss_and_control_point_gradient_match_jax(scenarios, ray_chunk):
    jax_scenario, scenario, du, de = scenarios
    render_fn, loss_fn, jax_cp = _jax_step(jax_scenario, du, de, ray_chunk, "scatter")
    inputs = _port_inputs(scenario, du, de, ray_chunk)
    cp = scenario.heliostat_groups[0].nurbs_control_points
    loss = chip_smoke.surface_loss(cp, inputs)
    np.testing.assert_allclose(float(loss), float(loss_fn(jax_cp)), rtol=1e-4)

    flux = np.asarray(render_fn(jax_cp)[0])
    spot = (flux > 0.05 * flux.max(axis=(1, 2), keepdims=True)).astype(np.float32)
    _, loss_fn, _ = _jax_step(jax_scenario, du, de, ray_chunk, "scatter", ground_truth=spot)
    loss_jax, grad_jax = jax.value_and_grad(loss_fn)(jax_cp)
    control_points = cp.clone().requires_grad_(True)
    loss = chip_smoke.surface_loss(
        control_points, dataclasses.replace(inputs, ground_truth=torch.tensor(spot))
    )
    loss.backward()
    grad, grad_jax = control_points.grad.numpy(), np.asarray(grad_jax)
    np.testing.assert_allclose(loss.item(), float(loss_jax), rtol=1e-4)
    assert np.abs(grad).max() > 0
    np.testing.assert_allclose(grad, grad_jax, rtol=0, atol=1e-3 * np.abs(grad_jax).max())


def test_checkpointed_chunks_rerun_the_splat_forward(scenarios, monkeypatch):
    """The launch counts chip_smoke.py asserts: two forward splats and one backward per chunk."""
    _, scenario, du, de = scenarios
    splat_module = sys.modules["artist_tpu_torch.kernels.splat"]
    calls = {"splat_forward": 0, "splat_backward": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)

        return wrapper

    monkeypatch.setattr(splat_module, "splat_forward_plain", counted("splat_forward", splat_module.splat_forward_plain))
    monkeypatch.setattr(splat_module, "splat_backward_plain", counted("splat_backward", splat_module.splat_backward_plain))
    control_points = scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    chip_smoke.surface_loss(control_points, _port_inputs(scenario, du, de, 1)).backward()
    assert calls == {"splat_forward": 2 * RAYS, "splat_backward": RAYS}


def test_port_synthetic_scenario_equals_converted(scenarios):
    _, converted, _, _ = scenarios
    built = make_synthetic_scenario(
        number_of_heliostats=HELIOSTATS, number_of_surface_points_per_facet=POINTS,
        number_of_rays=RAYS, device="cpu",
    )
    for ours, theirs in ((built.heliostat_groups[0], converted.heliostat_groups[0]), (built.solar_tower, converted.solar_tower)):
        for field in dataclasses.fields(ours):
            mine, other = getattr(ours, field.name), getattr(theirs, field.name)
            if isinstance(mine, torch.Tensor):
                assert mine.shape == other.shape, field.name
                torch.testing.assert_close(mine, other, rtol=1e-5, atol=2e-6, msg=field.name)
            else:
                assert mine == other, field.name
    assert built.light_sources == converted.light_sources
    assert built.heliostat_group_names == converted.heliostat_group_names
    np.testing.assert_array_equal(built.power_plant_position, converted.power_plant_position)


def test_bitmaps_per_target_ray_magnitude_and_losses(scenarios):
    jax_scenario, scenario, _, _ = scenarios
    rng = np.random.RandomState(12)
    bitmaps = rng.rand(4, 6, 5).astype(np.float32)
    truth = rng.rand(4, 6, 5).astype(np.float32)
    targets = np.array([1, 0, 1, 2])
    np.testing.assert_allclose(
        render.get_bitmaps_per_target(torch.tensor(bitmaps), torch.tensor(targets), 3).numpy(),
        np.asarray(jax_render.get_bitmaps_per_target(jnp.asarray(bitmaps), jnp.asarray(targets), 3)),
        rtol=1e-6,
    )
    canting = scenario.heliostat_groups[0].canting
    assert render.compute_ray_magnitude(900.0, canting, 100, 4) == pytest.approx(
        jax_render.compute_ray_magnitude(900.0, jax_scenario.heliostat_groups[0].canting, 100, 4), rel=1e-6
    )
    for name in ("kl_divergence_loss", "pixel_loss"):
        np.testing.assert_allclose(
            getattr(losses, name)(torch.tensor(bitmaps), torch.tensor(truth)).numpy(),
            np.asarray(getattr(jax_losses, name)(jnp.asarray(bitmaps), jnp.asarray(truth))),
            rtol=1e-5,
        )


@pytest.mark.parametrize("unported", ["cylinder", "chunk"])
def test_trace_rays_refuses_what_is_not_ported(scenarios, unported):
    """A ray chunk that does not divide the rays is refused. Cylindrical target areas
    are ported (``test_torch_cylinder.py``): a tower that also holds one is accepted,
    and heliostats aiming at its planar area get the planar tower's flux exactly."""
    _, scenario, du, de = scenarios
    if unported == "cylinder":
        inputs = _port_inputs(scenario, du, de, None)
        control_points = scenario.heliostat_groups[0].nurbs_control_points
        cylinder = chip_smoke.mixed_tower(torch.device("cpu"))
        mixed = dataclasses.replace(
            scenario.solar_tower,
            **{f.name: getattr(cylinder, f.name) for f in dataclasses.fields(cylinder) if f.name.startswith("cylindrical_")},
        )
        with torch.no_grad():
            planar = chip_smoke.render(control_points, inputs)
            inputs.scenario = dataclasses.replace(scenario, solar_tower=mixed)
            both = chip_smoke.render(control_points, inputs)
        assert mixed.number_of_cylindrical_target_areas == 1 and planar[0].sum() > 0
        for mine, other in zip(both, planar):
            torch.testing.assert_close(mine, other, rtol=0, atol=0)
        return
    config = render.RenderConfig(bitmap_resolution=BITMAP, ray_chunk=3)
    points = torch.zeros(HELIOSTATS, du.shape[2], 4)
    with pytest.raises(ValueError):
        render.trace_rays(
            scenario.solar_tower, points, points, torch.zeros(HELIOSTATS, 4), torch.zeros(HELIOSTATS, dtype=torch.long),
            torch.tensor(du), torch.tensor(de), config=config,
        )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card_or_the_package(where, tmp_path):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((REPO / "chip_smoke.py").read_text())
    done = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True, timeout=300
    )
    assert done.returncode != 0
    assert '"ok"' not in done.stdout


def test_chip_smoke_small_step_check_runs_on_the_cpu():
    """Rehearsal of chip_smoke.py's agreement phase, CPU against CPU."""
    chip_smoke.check_small_step_against_cpu(torch.device("cpu"))


def test_scenario_index_mapping_matches_jax(scenarios):
    jax_scenario, scenario, _, _ = scenarios
    east = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    south = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    mapping = [("H0002", "receiver", east), ("H0000", "receiver", south), ("H0002", "receiver", south)]
    for kwargs in ({}, {"string_mapping": mapping}, {"single_incident_ray_direction": east}):
        ours = scenario.index_mapping(scenario.heliostat_groups[0], **kwargs)
        theirs = jax_scenario.index_mapping(jax_scenario.heliostat_groups[0], **kwargs)
        for mine, other in zip(ours, theirs):
            np.testing.assert_array_equal(mine, other)
    with pytest.raises(ValueError, match="Invalid target"):
        scenario.index_mapping(scenario.heliostat_groups[0], string_mapping=[("H0000", "tower", east)])

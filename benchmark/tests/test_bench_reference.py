"""The benchmark's reference against the port at a tiny size on the CPU: each piece, then whole cells."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from artist_tpu_torch.field import kinematics_rigid_body as rigid_body
from artist_tpu_torch.flux.bitmap import crop_flux_distributions_around_center
from artist_tpu_torch.nurbs import create_nurbs_evaluation_grid, evaluate_nurbs_surfaces
from artist_tpu_torch.optim import losses
from artist_tpu_torch.raytracing.render import RenderConfig, trace_rays
from artist_tpu_torch.util import constants
from benchmark import run, traffic
from benchmark.field import field_arrays, reference_field
from benchmark.jobs import common
from benchmark.reference import geometry as geo
from benchmark.reference import render as rn

from conftest import TINY_FIELD, TINY_SEED

CPU = torch.device("cpu")


@pytest.fixture
def field(tiny_root):
    config = __import__("json").loads((tiny_root / "benchmark" / "configs" / "field100.json").read_text())
    return field_arrays(config["field"])


def tiny_motors(arrays, count: int = 12, seed: int = 3):
    rng = np.random.default_rng(seed)
    incident = torch.as_tensor(traffic.sun_incidence(rng, count, arrays["site"], (8.0, 16.0), 15.0))
    reference = reference_field(arrays, CPU)
    owner = torch.arange(count) % arrays["positions"].shape[0]
    deviations = torch.as_tensor(traffic.known_deviations(rng, count, (4.0, 8.0)))
    return reference, owner, incident, deviations


def test_nurbs_surfaces_match_the_port(field):
    grid = create_nurbs_evaluation_grid(field["surface_points"], device=CPU)
    np.testing.assert_array_equal(grid.numpy(), geo.evaluation_grid(*field["surface_points"], device=CPU).numpy())
    control = torch.as_tensor(field["control_points"][:2]).clone()
    control[..., 2] += torch.linspace(0, 2e-3, control[..., 2].numel()).reshape(control[..., 2].shape)
    canting, translations = torch.as_tensor(field["canting"][:2]), torch.as_tensor(field["translations"][:2])
    points, normals = evaluate_nurbs_surfaces(control, (3, 3), grid, canting=canting, facet_translations=translations)
    ours_points, ours_normals = geo.nurbs_surfaces(control, canting, translations, grid)
    np.testing.assert_allclose(ours_points.numpy(), points.reshape(2, -1, 4).numpy(), atol=2e-6)
    np.testing.assert_allclose(ours_normals.numpy(), normals.reshape(2, -1, 4).numpy(), atol=2e-6)


def test_kinematics_and_alignment_match_the_port(field):
    reference, owner, incident, deviations = tiny_motors(field)
    static, optimizable, positions = (reference[k][owner] for k in ("static", "optimizable", "positions"))
    port_static = static.clone()
    port_static[:, 0] = constants.linear_actuator_int
    aim = reference["receiver"]["aim"].expand(owner.shape[0], 4)
    ours, motors = geo.align_to_aim_points(positions, torch.zeros_like(deviations), static, optimizable, incident, aim)
    theirs, port_motors = rigid_body.incident_ray_directions_to_orientations(
        incident, aim, positions, torch.zeros((owner.shape[0], 9)), torch.zeros_like(deviations),
        constants.linear_actuator_key, port_static, optimizable,
    )
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-5)
    np.testing.assert_allclose(motors.numpy(), port_motors.numpy(), rtol=1e-5, atol=0.5)
    deviated = geo.motor_orientations(positions, deviations, static, optimizable, motors)
    port_deviated = rigid_body.motor_positions_to_orientations(
        motors, positions, torch.zeros((owner.shape[0], 9)), deviations, constants.linear_actuator_key, port_static,
        optimizable,
    )
    np.testing.assert_allclose(deviated.numpy(), port_deviated.numpy(), atol=1e-5)


def test_trace_crop_and_losses_match_the_port(field):
    reference, owner, incident, _ = tiny_motors(field, count=3)
    static, optimizable, positions = (reference[k][owner] for k in ("static", "optimizable", "positions"))
    aim = reference["receiver"]["aim"].expand(3, 4)
    orientation, _ = geo.align_to_aim_points(positions, torch.zeros((3, 4)), static, optimizable, incident, aim)
    grid = geo.evaluation_grid(*field["surface_points"], device=CPU)
    points, normals = geo.orient(*geo.nurbs_surfaces(reference["control_points"][owner], reference["canting"][owner],
                                                     reference["translations"][owner], grid), orientation)
    generator = torch.Generator().manual_seed(11)
    scatter_u, scatter_e = rn.sun_distortions(generator, 3, 16, points.shape[1], field["covariance"])
    ours = rn.trace(points, normals, incident, scatter_u, scatter_e, reference["receiver"], field["resolution"])
    scenario = common.port_scenario(field, CPU)
    theirs = trace_rays(scenario.solar_tower, points, normals, incident, torch.zeros(3, dtype=torch.long), scatter_u,
                        scatter_e, config=RenderConfig(bitmap_resolution=field["resolution"]))[0]
    assert float(theirs.sum()) > 0
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-4 * float(theirs.max()))
    crop = rn.crop_around_center(ours, reference["receiver"])
    port_crop = crop_flux_distributions_around_center(ours, scenario.solar_tower, torch.zeros(3, dtype=torch.long))
    np.testing.assert_allclose(crop.numpy(), port_crop.numpy(), atol=1e-5 * float(port_crop.max()))
    truth = torch.roll(crop, 1, dims=1) + 1e-3
    np.testing.assert_allclose(rn.kl_divergence(crop, truth).numpy(), losses.kl_divergence_loss(crop, truth).numpy(),
                               rtol=1e-5)
    spots = rn.receiver_points(rn.centers_of_mass(ours), reference["receiver"], field["resolution"])
    port_spots = losses.focal_spot_loss(ours, torch.cat([spots, torch.ones(3, 1)], dim=1), scenario.solar_tower,
                                        torch.zeros(3, dtype=torch.long))
    np.testing.assert_allclose(port_spots.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("cell", ["surface12.reconstruct", "field100.kinematics_raytracing"])
def test_a_tiny_cell_comes_out_correct(tiny_root, cell):
    """The whole run on the CPU: the port's first steps through its public entry against
    the reference's. (The alignment cell's numbers are not held here: its angles lie
    near zero, where one ulp of a dot product moves an arccos by ~1e-5 rad, and the
    CPU's vector and scalar paths of the kinematics' trigonometry part by an ulp; its
    pieces are held above.)"""
    result = run.run_cell(tiny_root, cell, TINY_SEED, 0.5, False, CPU)
    assert result["correct"], result["checked"]
    assert result["attempted"] > 0 and result["window"]["calls"] >= 1
    bench = run.manifest(tiny_root)
    # Every end-to-end metric of the cell but the card's peak memory, which the CPU has not.
    assert set(result["metrics"]) == {m["name"] for m in run.cell_metrics(bench, cell, False)} - {"peak_mem_gb"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checked"


def test_a_traced_tiny_run_reads_its_stretch(tiny_root):
    result = run.run_cell(tiny_root, "surface12.reconstruct", TINY_SEED, 0.5, True, CPU)
    assert result["attempted"] == result["window"]["epochs"] > 0
    assert result["device"]["window_s"] > 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10 and len(result["breakdown"]["device_ops"]) <= 10


def test_field_sizes_are_the_configuration_s(tiny_root):
    for name, size in TINY_FIELD.items():
        config = __import__("json").loads((tiny_root / "benchmark" / "configs" / f"{name}.json").read_text())
        arrays = field_arrays(config["field"])
        assert arrays["positions"].shape == (size["heliostats"], 4)
        assert arrays["control_points"].shape[1:] == (4, *config["field"]["control_points"], 3)


@pytest.mark.parametrize("cell", ["surface12.reconstruct", "field100.kinematics_alignment"])
def test_the_leaf_look_reads_the_worst_leaves(tiny_root, cell):
    from benchmark import leaves

    row = leaves.look(tiny_root, cell, TINY_SEED, CPU)
    assert len(row["leaves"]) == min(leaves.WORST, TINY_FIELD[cell.split(".")[0]]["heliostats"])
    assert row["leaves"][0]["gap"] == pytest.approx(row["gradient_gap"])
    if cell.startswith("surface"):
        assert all(value > 0 for value in row["largest_p_over_q"])
    else:
        assert set(row["smallest_angle_rad_of_worst_leaves"]) == {leaf["leaf"] for leaf in row["leaves"]}

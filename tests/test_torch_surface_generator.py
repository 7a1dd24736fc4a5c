"""The port's SurfaceGenerator against the JAX package's, on the CPU.

The clouds are ``chip_smoke``'s dented paraboloids written as STRAL files
(4 facets, from a numpy seed) and read back. JAX's loss history is recorded by
shadowing ``float`` in its module (its loop calls ``float`` once an epoch on the
loss before that epoch's update); the port keeps its own in ``loss_history``.

Tolerances, found on the CPU:

- the small fit (6 x 6 control points, every 500th of 20,000 points a facet,
  max_epoch 40): loss histories within 1e-4 relative (measured up to 2.3e-5:
  the same fp32 Adam, optax's against torch's arithmetic order) and control
  points within 5e-6 m (measured up to 6.6e-7);
- a loose ``tolerance`` between two losses more than 1% apart stops both at the same epoch;
- ideal surfaces: ``create_planar_nurbs_control_points`` in both, whose
  linspaces round one fp32 ulp apart: 1e-5 relative, 2e-6 m (as
  ``tests/test_torch_nurbs.py``);
- the paint_plots configuration (20 x 20, every 100th of 80,000 points, 401
  epochs): two fp32 Adam trajectories part once the loss nears 1e-9 (around
  epoch 90; a float64 run of the same loop parts from both alike), so the fits
  are held to ``chip_smoke``'s card-against-CPU bounds (``check_fit_gaps``):
  the same epochs, the first 50 losses within 1e-4, the last within a factor
  4, the normals on the 50 x 50 grid within 3e-4 rad on average. Measured: the
  first 50 within 1.1e-5, the last 1.1x apart, the normals 8.0e-5 rad.
"""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from artist_tpu.scenario import surface_generator as jax_surface_generator
from artist_tpu_torch.io.stral import extract_stral_deflectometry_data
from artist_tpu_torch.scenario.surface_generator import SurfaceGenerator
from artist_tpu_torch.util import constants

CPU = torch.device("cpu")
SMALL = dict(control_points=(6, 6), facet_points=20_000, step=500, max_epoch=40)
HISTORY_RTOL = 1e-4
CONTROL_POINT_ATOL = 5e-6
METHODS = [constants.fit_nurbs_from_points, constants.fit_nurbs_from_normals]


def _cloud(tmp_path, facet_points: int, heliostat: int = 0):
    path = tmp_path / f"heliostat_{heliostat}.binp"
    chip_smoke.write_ingress_stral(path, heliostat, facet_points, chip_smoke.ingress_dents(3)[heliostat])
    return extract_stral_deflectometry_data(path)


def _jax_fit(monkeypatch, fn):
    """``fn()`` with JAX's per-epoch losses recorded: (its result, the history)."""
    history = []

    def record(value):
        history.append(float(value))
        return history[-1]

    monkeypatch.setattr(jax_surface_generator, "float", record, raising=False)
    result = fn()
    monkeypatch.undo()
    return result, np.asarray(history)


def _homogeneous(cloud, step: int):
    count = min(p.shape[0] for p in cloud[2])
    points = np.stack([p[:count:step] for p in cloud[2]])
    normals = np.stack([n[:count:step] for n in cloud[3]])
    return (
        np.concatenate([points, np.ones(points.shape[:2] + (1,), np.float32)], axis=-1),
        np.concatenate([normals, np.zeros(normals.shape[:2] + (1,), np.float32)], axis=-1),
    )


@pytest.mark.parametrize("method", METHODS)
def test_fit_nurbs_matches_jax(tmp_path, monkeypatch, method):
    points, normals = _homogeneous(_cloud(tmp_path, SMALL["facet_points"]), SMALL["step"])
    generator = SurfaceGenerator(number_of_control_points=SMALL["control_points"])
    ours = generator.fit_nurbs(
        torch.tensor(points), torch.tensor(normals), fit_method=method, max_epoch=SMALL["max_epoch"]
    ).numpy()
    theirs, history = _jax_fit(monkeypatch, lambda: np.asarray(
        jax_surface_generator.SurfaceGenerator(number_of_control_points=SMALL["control_points"]).fit_nurbs(
            points, normals, fit_method=method, max_epoch=SMALL["max_epoch"]
        )
    ))
    assert ours.shape == theirs.shape == (4, 6, 6, 3)
    assert len(generator.loss_history) == len(history) == SMALL["max_epoch"] + 1
    np.testing.assert_allclose(generator.loss_history, history, rtol=HISTORY_RTOL, atol=0)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=CONTROL_POINT_ATOL)
    assert generator.loss_history[-1] < generator.loss_history[0]


@pytest.mark.parametrize("method", METHODS)
def test_a_loose_tolerance_stops_both_at_the_same_epoch(tmp_path, monkeypatch, method):
    points, normals = _homogeneous(_cloud(tmp_path, SMALL["facet_points"]), SMALL["step"])
    full = SurfaceGenerator(number_of_control_points=SMALL["control_points"])
    full.fit_nurbs(torch.tensor(points), torch.tensor(normals), fit_method=method, max_epoch=SMALL["max_epoch"])
    history = np.asarray(full.loss_history)
    # Stop at the epoch in 10..max_epoch - 1 whose loss drops most below the one before
    # it, by far more than the histories' tolerance.
    stop = 10 + int(np.argmax(1 - history[10:-1] / history[9:-2]))
    assert 1 - history[stop] / history[stop - 1] > 100 * HISTORY_RTOL
    tolerance = float(np.sqrt(history[stop] * history[stop - 1]))
    generator = SurfaceGenerator(number_of_control_points=SMALL["control_points"])
    generator.fit_nurbs(
        torch.tensor(points), torch.tensor(normals), fit_method=method, tolerance=tolerance,
        max_epoch=SMALL["max_epoch"],
    )
    _, jax_history = _jax_fit(monkeypatch, lambda: jax_surface_generator.SurfaceGenerator(
        number_of_control_points=SMALL["control_points"]
    ).fit_nurbs(points, normals, fit_method=method, tolerance=tolerance, max_epoch=SMALL["max_epoch"]))
    assert len(generator.loss_history) == len(jax_history) == stop + 1 < SMALL["max_epoch"] + 1
    assert generator.loss_history[-1] <= tolerance < generator.loss_history[-2]


def _assert_same_surface(ours, theirs, control_point_atol: float = CONTROL_POINT_ATOL) -> None:
    assert [f.facet_key for f in ours.facet_list] == [f.facet_key for f in theirs.facet_list]
    for mine, other in zip(ours.facet_list, theirs.facet_list):
        assert mine.control_points.dtype == other.control_points.dtype == np.float32
        np.testing.assert_allclose(mine.control_points, other.control_points, rtol=0, atol=control_point_atol)
        for name in ("degrees", "translation_vector", "canting"):
            assert getattr(mine, name).dtype == getattr(other, name).dtype, name
            np.testing.assert_array_equal(getattr(mine, name), getattr(other, name), err_msg=name)


@pytest.mark.parametrize("method", METHODS)
def test_generate_fitted_surface_config_matches_jax(tmp_path, monkeypatch, method):
    translations, canting, points, normals = _cloud(tmp_path, SMALL["facet_points"])
    # Unequal facet clouds: each is cut to the smallest before the stride.
    points[1], normals[1] = points[1][:-777], normals[1][:-777]
    arguments = dict(
        heliostat_name="AA39", facet_translation_vectors=translations, canting=canting,
        surface_points_with_facets_list=points, surface_normals_with_facets_list=normals,
        deflectometry_step_size=SMALL["step"], fit_method=method, max_epoch=SMALL["max_epoch"],
    )
    ours = SurfaceGenerator(SMALL["control_points"]).generate_fitted_surface_config(**arguments, device="cpu")
    theirs, _ = _jax_fit(monkeypatch, lambda: jax_surface_generator.SurfaceGenerator(
        SMALL["control_points"]
    ).generate_fitted_surface_config(**arguments))
    _assert_same_surface(ours, theirs)
    zeroed = method == constants.fit_nurbs_from_points
    for facet, translation in zip(ours.facet_list, translations):
        np.testing.assert_array_equal(facet.translation_vector, 0.0 if zeroed else translation)


def test_generate_ideal_surface_config_matches_jax():
    translations, canting = chip_smoke.ingress_facets()
    canting = canting * np.float32(1.1)
    for control_points in ((4, 4), (7, 5)):
        ours = SurfaceGenerator(control_points).generate_ideal_surface_config(translations, canting)
        theirs = jax_surface_generator.SurfaceGenerator(control_points).generate_ideal_surface_config(
            translations, canting
        )
        # The linspaces of the two packages round one fp32 ulp apart.
        for mine, other in zip(ours.facet_list, theirs.facet_list):
            np.testing.assert_allclose(mine.control_points, other.control_points, rtol=1e-5, atol=2e-6)
            assert mine.control_points.shape == control_points + (3,)
            np.testing.assert_array_equal(mine.control_points[..., 2], 0.0)
            np.testing.assert_array_equal(mine.translation_vector, other.translation_vector)
            np.testing.assert_array_equal(mine.canting, other.canting)
            np.testing.assert_array_equal(mine.degrees, other.degrees)


def test_unknown_fit_method_raises():
    points = torch.zeros((4, 4))
    with pytest.raises(NotImplementedError, match="laser_scan"):
        SurfaceGenerator((5, 5)).fit_nurbs(points, points, fit_method="laser_scan")


def test_paint_plots_configuration_fit_within_the_card_gates(tmp_path, monkeypatch):
    """The port's CPU fit against JAX's at phase 15's configuration, held to the
    bounds phase 15 holds the card's fit to against the CPU's."""
    size = chip_smoke.INGRESS
    cloud = _cloud(tmp_path, size["facet_points"])
    ours = chip_smoke.fit_stral_heliostat(CPU, "AA39", cloud, size)
    theirs, history = _jax_fit(monkeypatch, lambda: jax_surface_generator.SurfaceGenerator(
        size["control_points"], (3, 3)
    ).generate_fitted_surface_config(
        "AA39", *cloud, deflectometry_step_size=size["step"], max_epoch=size["max_epoch"], **chip_smoke.INGRESS_FIT
    ))
    gaps = chip_smoke.fit_gaps(ours, dict(surface=theirs, history=history), size["surface_points"])
    chip_smoke.check_fit_gaps("the port's cpu fit against the JAX package's", gaps)
    assert gaps["epochs"] == [size["max_epoch"] + 1] * 2
    assert ours["history"][-1] * size["loss_factor"] < ours["history"][0]


def test_chip_smoke_phase_15_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 15's functions end to end with the CPU in the card's place,
    at a small size (its gates loosened to what that size can reach: 6 x 6 control
    points, 40 epochs, 4 rays a point), and the launch rule the card's run is held to,
    counted through the splats' plain versions."""
    splat_module = sys.modules["artist_tpu_torch.kernels.splat"]
    calls = {"splat_forward": 0, "splat_backward": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)

        return wrapper

    for name in calls:
        monkeypatch.setattr(splat_module, f"{name}_plain", counted(name, getattr(splat_module, f"{name}_plain")))
    size = dict(
        chip_smoke.INGRESS, facet_points=3000, control_points=(6, 6), max_epoch=40, surface_points=(8, 8), rays=4,
        bitmap=(64, 64), loss_factor=10.0, mean_angle=5e-3, flux_l1=1.0,
    )
    result, group, tower, distortions = chip_smoke.drive_data_ingress(CPU, size)
    assert calls == {"splat_forward": 3, "splat_backward": 0}
    assert result["epochs"] == [41, 41, 41] and result["group_names"] == ["rigid_body_linear"]
    assert group.names == chip_smoke.INGRESS_HELIOSTATS and group.surface_points.shape == (3, 4 * 64, 4)
    assert result["cpu_gaps"]["early_rtol"] == 0 and result["cpu_gaps"]["normal_max_angle"] == 0
    assert all(angle < size["mean_angle"] for angle in result["normal_mean_angles"])
    assert result["grid_border_angle"] > result["grid_interior_angle"] > 0
    assert distortions[0].shape == (3, 4, 256) and tower.planar_names == ("receiver",)
    rays = chip_smoke.ingress_rays(group, tower, distortions, size)
    assert [tuple(x.shape) for x in rays] == [(3, 4 * 256)] * 3
    assert chip_smoke.ingress_launches(size) == chip_smoke.launches(splat_forward=3)
    assert chip_smoke.ingress_launches(dict(size, ray_chunk=2)) == chip_smoke.launches(splat_forward=6)


def test_the_fit_logs_every_100_epochs_as_jax(tmp_path, caplog):
    points, normals = _homogeneous(_cloud(tmp_path, 2000), 100)
    with caplog.at_level("INFO"):
        SurfaceGenerator((4, 4)).fit_nurbs(torch.tensor(points), torch.tensor(normals), max_epoch=205)
        ours = [r.getMessage() for r in caplog.records if r.name == "artist_tpu_torch.scenario"]
        caplog.clear()
        jax_surface_generator.SurfaceGenerator((4, 4)).fit_nurbs(points, normals, max_epoch=205)
        theirs = [r.getMessage() for r in caplog.records if r.name == "artist_tpu.scenario"]
    assert [m.split(",")[0] for m in ours] == [m.split(",")[0] for m in theirs] == [
        "Epoch: 0", "Epoch: 100", "Epoch: 200"
    ]

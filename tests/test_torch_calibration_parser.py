"""The port's PAINT calibration parser and flux PNG loader against the JAX package's.

The tests write PAINT calibration-properties JSON files (the keys the JAX
parser reads) and flux PNGs (with PIL, in grey and in colour, at the bitmap's
size and at others, so that the bilinear resize runs) from a numpy seed. Both
packages must return equal ``CalibrationData``: the fluxes bit for bit (the same
PIL resize and float32 division), the rest too (the same host numpy in float64,
cast to float32). Then the port's surface and kinematics reconstructors run a
few epochs on what the port's parser returns, on a scenario the port wrote and
loaded.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from artist_tpu.io import calibration as jax_calibration
from artist_tpu_torch.io import calibration
from artist_tpu_torch.optim.kinematics_reconstructor import KinematicsReconstructor
from artist_tpu_torch.optim.surface_reconstructor import SurfaceReconstructor
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.scenario.scenario import load_scenario_from_hdf5
from artist_tpu_torch.scenario.surface_generator import SurfaceGenerator
from artist_tpu_torch.util import config, constants

POWER_PLANT = np.array([50.91342112259258, 6.387824755874856, 87.0])
TARGETS = {"receiver": 0, "multi_focus_tower": 1}
HELIOSTATS = ("AA39", "AB40", "AC41")
BITMAP = (32, 32)
SIZES = [(32, 32), (64, 48), (20, 30)]


def write_calibration(directory, heliostat: str, count: int, seed: int, variant: str = "flux"):
    """``count`` calibration samples of one heliostat in ``directory``: each a properties
    JSON and a flux PNG. Returns the (properties, images) paths."""
    rng = np.random.RandomState(seed)
    directory.mkdir(parents=True, exist_ok=True)
    properties, images = [], []
    for i in range(count):
        identifier = 1000 * seed + i
        centre = [POWER_PLANT[0] - 2.7e-5 + rng.normal(0, 2e-6), POWER_PLANT[1] + rng.normal(0, 3e-6),
                  POWER_PLANT[2] + 45.0 + rng.normal(0, 0.3)]
        data = {
            "motor_position": {
                "axis_1_motor_position": int(rng.randint(20000, 40000)),
                "axis_2_motor_position": int(rng.randint(30000, 60000)),
            },
            "target_name": list(TARGETS)[i % 2],
            "sun_azimuth": float(rng.uniform(-60, 60)),
            "sun_elevation": float(rng.uniform(20, 60)),
            "focal_spot": {
                "UTIS": centre,
                "HeliOS": [c + rng.normal(0, 1e-7) for c in centre],
            },
        }
        path = directory / f"{identifier}-calibration-properties.json"
        path.write_text(json.dumps(data))
        properties.append(path)
        size = SIZES[i % len(SIZES)]
        yy, xx = np.mgrid[0 : size[1], 0 : size[0]]
        spot = np.exp(-((xx / size[0] - rng.uniform(0.3, 0.7)) ** 2 + (yy / size[1] - rng.uniform(0.3, 0.7)) ** 2) / 0.02)
        grey = (255 * spot).astype(np.uint8)
        image = Image.fromarray(np.stack([grey, grey // 2, grey // 3], axis=-1), "RGB") if i % 2 else Image.fromarray(grey, "L")
        image_path = directory / f"{identifier}-{variant}.png"
        image.save(image_path)
        images.append(image_path)
    return properties, images


@pytest.fixture(scope="module")
def mapping(tmp_path_factory):
    base = tmp_path_factory.mktemp("paint")
    return [
        (name, *write_calibration(base / name / "Calibration", name, count, seed=i + 1))
        for i, (name, count) in enumerate(zip(HELIOSTATS, (4, 3, 5)))
    ]


def _assert_same_calibration(ours, theirs) -> None:
    for name in ("flux_measured", "focal_spots", "incident_ray_directions", "motor_positions",
                 "active_heliostats_mask", "target_area_indices"):
        mine, other = getattr(ours, name), getattr(theirs, name)
        assert mine.dtype == other.dtype and mine.shape == other.shape, name
        np.testing.assert_array_equal(mine, other, err_msg=name)


@pytest.mark.parametrize("limit", [None, 2])
def test_load_flux_from_png_matches_jax_and_pil(mapping, limit):
    flux_mapping = [(name, images) for name, _, images in mapping]
    names = ("AC41", "AA39")
    ours = calibration.load_flux_from_png(flux_mapping, names, BITMAP, limit)
    theirs = jax_calibration.load_flux_from_png(flux_mapping, names, BITMAP, limit)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == ((2 + 2) if limit else (5 + 4), 32, 32)
    np.testing.assert_array_equal(ours, theirs)
    first = Image.open(dict(flux_mapping)["AC41"][1]).convert("L").resize(BITMAP, Image.Resampling.BILINEAR)
    np.testing.assert_array_equal(ours[1], np.asarray(first, np.float32) / 255.0)
    assert calibration.load_flux_from_png([], names, (8, 6)).shape == (0, 6, 8)


@pytest.mark.parametrize("limit", [None, 2])
@pytest.mark.parametrize("method", ["UTIS", "HeliOS"])
def test_paint_calibration_parser_matches_jax(mapping, method, limit):
    arguments = dict(
        heliostat_data_mapping=mapping, heliostat_names=("AB40", "AA39", "ZZ99"),
        target_name_to_index=TARGETS, power_plant_position=POWER_PLANT, bitmap_resolution=BITMAP,
    )
    ours = calibration.PaintCalibrationDataParser(limit, method).parse_data_for_reconstruction(**arguments)
    theirs = jax_calibration.PaintCalibrationDataParser(limit, method).parse_data_for_reconstruction(**arguments)
    _assert_same_calibration(ours, theirs)
    counts = [2, 2, 0] if limit else [3, 4, 0]
    np.testing.assert_array_equal(ours.active_heliostats_mask, counts)
    assert ours.flux_measured.shape == (sum(counts), 32, 32)
    np.testing.assert_allclose(np.linalg.norm(ours.incident_ray_directions[:, :3], axis=1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(ours.incident_ray_directions[:, 3], 0.0)
    np.testing.assert_array_equal(ours.focal_spots[:, 3], 1.0)
    assert (ours.incident_ray_directions[:, 2] < 0).all()  # the sun above the horizon


def test_unknown_centroid_method_raises():
    with pytest.raises(ValueError, match="centroid extraction method laser"):
        calibration.PaintCalibrationDataParser(centroid_extraction_method="laser")
    with pytest.raises(ValueError, match="centroid extraction method laser"):
        jax_calibration.PaintCalibrationDataParser(centroid_extraction_method="laser")


def _scenario(tmp_path):
    """A two-heliostat scenario (AA39 and AB40) that the port writes and loads on the CPU."""
    translations, canting = chip_smoke.ingress_facets()
    surface = SurfaceGenerator((4, 4)).generate_ideal_surface_config(translations, canting)
    actuators = config.ActuatorListConfig(
        actuator_list=[
            config.ActuatorConfig(
                actuator_key=f"actuator_{i}", clockwise_axis_movement=bool(i),
                min_max_motor_positions=np.array([0, 70000]),
                parameters=config.ActuatorParameters(
                    increment=154166.67, initial_stroke_length=0.075, offset=0.34, pivot_radius=0.32, initial_angle=0.5,
                ),
            )
            for i in range(2)
        ]
    )
    path = H5ScenarioGenerator(
        tmp_path / "scenario.h5",
        power_plant_config=config.PowerPlantConfig(power_plant_position=POWER_PLANT),
        target_area_list_planar_config=[
            config.TargetAreaPlanarConfig(name, np.array([3.0 * i, -3.0, 45.0, 1.0]), np.array([0.0, 1.0, 0.0, 0.0]), 8.0, 7.0)
            for name, i in TARGETS.items()
        ],
        target_area_list_cylindrical_config=[],
        light_source_list_config=config.LightSourceListConfig(
            light_source_list=[config.LightSourceConfig("sun_1", number_of_rays=4)]
        ),
        heliostat_list_config=config.HeliostatListConfig(
            heliostat_list=[
                config.HeliostatConfig(name=name, heliostat_id=i, position=np.array([8.0 * i - 4.0, 25.0, 1.7, 1.0]))
                for i, name in enumerate(HELIOSTATS[:2])
            ]
        ),
        prototype_config=config.PrototypeConfig(surface, config.KinematicsConfig(), actuators),
    ).generate_scenario()
    return load_scenario_from_hdf5(path, number_of_surface_points_per_facet=(4, 4), device="cpu")


def test_the_reconstructors_accept_what_the_parser_returns(tmp_path, mapping):
    """Both reconstructors read the port's PAINT parser through their data dict and
    run a few epochs on the port's loaded scenario."""
    data = {constants.data_parser: calibration.PaintCalibrationDataParser(), constants.heliostat_data_mapping: mapping}
    surface = SurfaceReconstructor(
        _scenario(tmp_path), data,
        chip_smoke.reconstruction_configuration(1, lr_min=1e-5, lr_max=3e-5, step_size_up=2),
        number_of_surface_points=(4, 4), bitmap_resolution=BITMAP,
    )
    final_loss, results = surface.reconstruct_surfaces()
    assert np.isfinite(np.asarray(final_loss)).all() and np.asarray(final_loss).shape == (2,)
    assert all(np.isfinite(v).all() for v in results[0].loss_history.values())
    for method in (constants.kinematics_reconstruction_alignment, constants.kinematics_reconstruction_raytracing):
        kinematics = KinematicsReconstructor(
            _scenario(tmp_path), data, chip_smoke.kinematics_configuration(2), reconstruction_method=method,
            bitmap_resolution=BITMAP,
        )
        final_loss, (result,) = kinematics.reconstruct_kinematics()
        assert np.isfinite(np.asarray(final_loss)).all() and len(result.loss_history) >= 1
        assert np.isfinite(result.loss_history).all()

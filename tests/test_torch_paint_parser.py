"""The port's PAINT scenario parser against the JAX package's.

The tests write the PAINT files from a numpy seed, with the keys the JAX
parsers read: a tower-measurements JSON (two planar target areas, the convex
cylindrical receiver whose corners carry the ``receiver_inner_`` prefix, and a
second cylinder without it), heliostat-properties JSONs, deflectometry HDF5s
in ``extract_paint_deflectometry_data``'s layout (``facet<i>/surface_points``,
``surface_normals``) and calibration directories. Both packages must give
equal configs (their ``create_*_dict`` serialisations key by key, the same
host numpy), equal deflectometry clouds and the same shuffled order of
calibration files (Python's ``random.Random(seed)`` in both). The fitted
configs' fitted control points are the two packages' fp32 fits: within 5e-6 m
(``tests/test_torch_surface_generator.py``).
"""

import json

import h5py
import numpy as np
import pytest

import chip_smoke
from artist_tpu.io import paint_scenario_parser as jax_parser
from artist_tpu_torch.io import paint_scenario_parser as parser
from test_torch_config import assert_same_dict

POWER_PLANT = [50.91342112259258, 6.387824755874856, 87.0]
FIT = dict(number_of_nurbs_control_points=(6, 6), deflectometry_step_size=100, nurbs_fit_max_epoch=10)


def _wgs84(rng, east: float, north: float, up: float) -> list[float]:
    """A WGS84 point about ``(east, north, up)`` m from the power plant, jittered."""
    return [
        POWER_PLANT[0] + (north + rng.normal(0, 0.01)) / 111_200.0,
        POWER_PLANT[1] + (east + rng.normal(0, 0.01)) / 70_100.0,
        POWER_PLANT[2] + up + rng.normal(0, 0.01),
    ]


def _corners(rng, centre, width, height, prefix=""):
    e, n, u = centre
    return {
        f"{prefix}upper_left": _wgs84(rng, e - width / 2, n, u + height / 2),
        f"{prefix}upper_right": _wgs84(rng, e + width / 2, n, u + height / 2),
        f"{prefix}lower_left": _wgs84(rng, e - width / 2, n, u - height / 2),
        f"{prefix}lower_right": _wgs84(rng, e + width / 2, n, u - height / 2),
    }


def write_tower(path, seed: int = 0):
    rng = np.random.RandomState(seed)
    tower = {"power_plant_properties": {"coordinates": POWER_PLANT}}
    for name, centre in (("solar_tower_juelich_upper", (0.0, -3.0, 45.0)), ("multi_focus_tower", (25.0, -3.0, 38.0))):
        tower[name] = {
            "type": "planar",
            "coordinates": {"center": _wgs84(rng, *centre), **_corners(rng, centre, 8.0, 7.0)},
            "normal_vector": [0.0, 1.0, 0.0],
        }
    for name, prefix in (("receiver", "receiver_inner_"), ("second_cylinder", "")):
        tower[name] = {
            "type": "convex_cylinder",
            "coordinates": _corners(rng, (-20.0, -3.0, 50.0), 4.0, 5.0, prefix),
            "normal_vector": [0.0, 1.0, 0.0],
            "radius": 3.0,
            "opening_angle": 80.0 + 10.0 * len(prefix),
        }
    path.write_text(json.dumps(tower))
    return path


def write_heliostat(path, seed: int):
    rng = np.random.RandomState(seed)
    translations, canting = chip_smoke.ingress_facets()
    properties = {
        "heliostat_position": _wgs84(rng, rng.uniform(-30, 30), rng.uniform(20, 80), 1.7),
        "facet_properties": {
            "number_of_facets": 4,
            "facets": [
                {
                    "translation_vector": (translations[i, :3] + rng.normal(0, 1e-4, 3)).tolist(),
                    "canting_e": canting[i, 0, :3].tolist(),
                    "canting_n": canting[i, 1, :3].tolist(),
                }
                for i in range(4)
            ],
        },
        "kinematics_properties": {
            **{key: float(rng.normal(0, 0.01)) for key in parser._DEVIATION_KEYS.values()},
            "actuators": [
                {
                    "type_axis": "linear",
                    "clockwise_axis_movement": i,
                    "min_increment": 0,
                    "max_increment": int(rng.randint(60000, 80000)),
                    **{key: float(rng.uniform(0.05, 0.5)) for key in parser._ACTUATOR_PARAMETER_KEYS.values()},
                }
                for i in range(2)
            ],
        },
        "initial_orientation": [0.0, -1.0, 0.0],
    }
    path.write_text(json.dumps(properties))
    return path


def write_deflectometry(path, seed: int, facet_points: int = 2000):
    """A PAINT deflectometry file: each facet's dented paraboloid (``chip_smoke``) cloud."""
    rng = np.random.RandomState(seed)
    dent = rng.uniform(-1.0, 1.0, 2)
    with h5py.File(path, "w") as file:
        for facet in range(4):
            e = rng.uniform(-0.8, 0.8, facet_points + 17 * facet)
            n = rng.uniform(-0.6, 0.6, facet_points + 17 * facet)
            points, normals = chip_smoke.facet_local_surface(e, n, facet, dent)
            group = file.create_group(f"facet{facet + 1}")
            group["surface_points"] = points.astype(np.float32)
            group["surface_normals"] = normals.astype(np.float32)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("paint")
    heliostats = []
    for i, name in enumerate(("AA39", "AB40", "AC41")):
        heliostats.append(
            (name, write_heliostat(base / f"{name}-heliostat-properties.json", i + 10),
             write_deflectometry(base / f"{name}-deflectometry.h5", i + 20))
        )
    return write_tower(base / "tower-measurements.json"), heliostats


def _assert_same_configs(ours, theirs) -> None:
    """Heliostat lists and prototypes, by their serialisations."""
    (heliostats, prototype), (jax_heliostats, jax_prototype) = ours, theirs
    assert [h.name for h in heliostats.heliostat_list] == [h.name for h in jax_heliostats.heliostat_list]
    for mine, other in zip(heliostats.heliostat_list, jax_heliostats.heliostat_list):
        _assert_close_dict(mine.create_heliostat_dict(), other.create_heliostat_dict())
    _assert_close_dict(prototype.create_prototype_dict(), jax_prototype.create_prototype_dict())


def _assert_close_dict(ours: dict, theirs: dict, path: str = "") -> None:
    """As ``assert_same_dict``, but fitted control points within 5e-6 m."""
    assert list(ours) == list(theirs), path
    for key in ours:
        where = f"{path}/{key}"
        if isinstance(theirs[key], dict):
            _assert_close_dict(ours[key], theirs[key], where)
        elif key == "control_points":
            assert ours[key].dtype == theirs[key].dtype and ours[key].shape == theirs[key].shape, where
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=5e-6, err_msg=where)
        else:
            assert_same_dict({key: ours[key]}, {key: theirs[key]}, path)


def test_tower_measurements_match_jax(files):
    tower, _ = files
    ours = parser.extract_paint_tower_measurements(tower)
    theirs = jax_parser.extract_paint_tower_measurements(tower)
    assert_same_dict(ours[0].create_power_plant_dict(), theirs[0].create_power_plant_dict())
    for mine, other in zip(ours[1:], theirs[1:]):
        assert [t.target_area_key for t in mine] == [t.target_area_key for t in other]
        for a, b in zip(mine, other):
            assert_same_dict(a.create_target_area_dict(), b.create_target_area_dict(), a.target_area_key)
    assert [t.target_area_key for t in ours[1]] == ["solar_tower_juelich_upper", "multi_focus_tower"]
    assert [t.target_area_key for t in ours[2]] == ["receiver", "second_cylinder"]
    # The corners span the written 8 x 7 m, and the cylinders open by the written angles.
    assert abs(ours[1][0].plane_e - 8.0) < 0.05 and abs(ours[1][0].plane_u - 7.0) < 0.05
    np.testing.assert_allclose([c.opening_angle for c in ours[2]], np.deg2rad([230.0, 80.0]))


def test_heliostat_properties_match_jax(files):
    _, heliostats = files
    for _, properties, _ in heliostats:
        ours = parser.extract_paint_heliostat_properties(properties, np.asarray(POWER_PLANT))
        theirs = jax_parser.extract_paint_heliostat_properties(properties, np.asarray(POWER_PLANT))
        for mine, other in zip(ours[:3] + ours[4:5], theirs[:3] + theirs[4:5]):
            assert mine.dtype == other.dtype
            np.testing.assert_array_equal(mine, other)
        assert_same_dict(ours[3].create_kinematics_deviations_dict(), theirs[3].create_kinematics_deviations_dict())
        assert [a[:3] for a in ours[5]] == [a[:3] for a in theirs[5]]
        for mine, other in zip(ours[5], theirs[5]):
            assert_same_dict(mine[3].create_actuator_parameters_dict(), other[3].create_actuator_parameters_dict())


def test_deflectometry_data_match_jax(files):
    _, heliostats = files
    ours = parser.extract_paint_deflectometry_data(heliostats[0][2], 4)
    theirs = jax_parser.extract_paint_deflectometry_data(heliostats[0][2], 4)
    for mine, other in zip(ours[0] + ours[1], theirs[0] + theirs[1]):
        assert mine.dtype == other.dtype == np.float32
        np.testing.assert_array_equal(mine, other)
    assert [p.shape[0] for p in ours[0]] == [2000, 2017, 2034, 2051]


def test_ideal_surface_configs_match_jax(files):
    _, heliostats = files
    paths = [(name, properties) for name, properties, _ in heliostats]
    ours = parser.extract_paint_heliostats_ideal_surface(paths, np.asarray(POWER_PLANT), (5, 4))
    theirs = jax_parser.extract_paint_heliostats_ideal_surface(paths, np.asarray(POWER_PLANT), (5, 4))
    _assert_same_configs(ours, theirs)


def test_fitted_surface_configs_match_jax(files):
    _, heliostats = files
    ours = parser.extract_paint_heliostats_fitted_surface(heliostats[:2], np.asarray(POWER_PLANT), **FIT, device="cpu")
    theirs = jax_parser.extract_paint_heliostats_fitted_surface(heliostats[:2], np.asarray(POWER_PLANT), **FIT)
    _assert_same_configs(ours, theirs)
    facet = ours[0].heliostat_list[0].surface.facet_list[0]
    assert facet.control_points.shape == (6, 6, 3) and np.any(facet.control_points[..., 2] != 0)


def test_mixed_surface_configs_match_jax(files):
    """Fitted where deflectometry exists, ideal otherwise; the ideal heliostats first."""
    _, heliostats = files
    paths = [heliostats[0], (heliostats[1][0], heliostats[1][1], None), heliostats[2][:2]]
    ours = parser.extract_paint_heliostats_mixed_surface(paths, np.asarray(POWER_PLANT), **FIT, device="cpu")
    theirs = jax_parser.extract_paint_heliostats_mixed_surface(paths, np.asarray(POWER_PLANT), **FIT)
    _assert_same_configs(ours, theirs)
    assert [h.name for h in ours[0].heliostat_list] == ["AB40", "AC41", "AA39"]
    with pytest.raises(ValueError, match="No heliostats"):
        parser.extract_paint_heliostats_mixed_surface([], np.asarray(POWER_PLANT))


def _calibration_directory(base, name: str, identifiers: list[int], missing_images: set[int]):
    directory = base / name / "Calibration"
    directory.mkdir(parents=True)
    for identifier in identifiers:
        (directory / f"{identifier}-calibration-properties.json").write_text("{}")
        if identifier not in missing_images:
            (directory / f"{identifier}-flux.png").write_bytes(b"")


@pytest.mark.parametrize("randomize", [True, False])
@pytest.mark.parametrize("seed", [42, 7])
def test_heliostat_data_mapping_matches_jax(tmp_path, randomize, seed):
    rng = np.random.RandomState(seed)
    _calibration_directory(tmp_path, "AA39", list(rng.choice(100000, 12, replace=False)), set())
    _calibration_directory(tmp_path, "AB40", list(rng.choice(100000, 6, replace=False)), missing_images={0})
    identifiers = list(rng.choice(100000, 5, replace=False))
    _calibration_directory(tmp_path, "AC41", identifiers, missing_images=set(identifiers[:3]))
    arguments = dict(
        base_path=tmp_path, heliostat_names=["AC41", "AA39", "ZZ99", "AB40"], number_of_measurements=4,
        image_variant="flux", randomize=randomize, seed=seed,
    )
    ours = parser.build_heliostat_data_mapping(**arguments)
    theirs = jax_parser.build_heliostat_data_mapping(**arguments)
    assert ours == theirs
    assert [name for name, _, _ in ours] == ["AC41", "AA39", "AB40"]
    assert [len(properties) for _, properties, _ in ours] == [2, 4, 4]
    if not randomize:
        assert ours[1][1] == sorted(ours[1][1])

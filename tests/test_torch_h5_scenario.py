"""Scenario HDF5 files: the port's writer and loader against the JAX package's.

Each scenario is specified once in numpy (a seed) and built into either
package's config dataclasses. Both writers must produce the same file (every
dataset's path, dtype, shape and value, and the attributes), and each package
must load both files into the same scenario: the same groups in the same order
(by first appearance over h5py's key order), every field of every group, the
tower, the light sources. The scenarios cover prototype-only and per-heliostat
sections, planar and fitted (non-planar) surfaces,
``change_number_of_control_points_per_facet``, linear and ideal actuators in one
file (two groups), linear actuators without parameters (defaults with
warnings), two light sources and a cylindrical target area. The error paths of
``tests/scenario/test_broken_scenarios.py`` are built here by corrupting a copy
of a valid file. Then the port's loaded scenario is traced against JAX's.

Tolerances: everything the loaders copy from the file, and every host
computation (the initial-angle compensation in float64), is equal. Surfaces
sampled from the NURBS and replanned control points are the two packages'
fp32 NURBS evaluations: ``rtol = 1e-5, atol = 2e-6`` (``tests/test_torch_nurbs.py``).
The trace is held as ``tests/test_torch_render.py`` holds it: the flux to
1e-4 of its peak, the factors to 1e-6.
"""

import dataclasses
import logging
import pathlib
import shutil

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.raytracing import render as jax_render
from artist_tpu.scenario import scenario as jax_scenario
from artist_tpu.scenario.h5_generator import H5ScenarioGenerator as JaxGenerator
from artist_tpu.util import config as jax_config
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.nurbs import create_planar_nurbs_control_points
from artist_tpu_torch.raytracing import render
from artist_tpu_torch.scenario import scenario
from artist_tpu_torch.scenario.h5_generator import H5ScenarioGenerator
from artist_tpu_torch.util import config, constants

CPU = torch.device("cpu")
POINTS = (5, 4)
NURBS = dict(rtol=1e-5, atol=2e-6)
SAMPLED_FIELDS = {"surface_points", "surface_normals"}
CASES = ("prototype_only", "individual", "two_groups", "cylindrical")


# --------------------------------------------------------------------------- #
# The scenarios, in numpy, and their configs in either package.
# --------------------------------------------------------------------------- #


def _surface(kind: str, rng: np.random.RandomState) -> dict:
    translations, canting = chip_smoke.ingress_facets()
    control_points = create_planar_nurbs_control_points((6, 6), torch.tensor(canting)).numpy()
    if kind == "fitted":
        # A fitted surface: translated control points on a paraboloid (f = 50 m) with
        # millimetre noise, as a fit of a deflectometry cloud leaves them.
        control_points = control_points + translations[:, None, None, :3]
        e, n = control_points[..., 0], control_points[..., 1]
        control_points[..., 2] += (e**2 + n**2) / 200.0 + rng.normal(0.0, 1e-4, e.shape).astype(np.float32)
    return dict(control_points=control_points, translations=translations, canting=canting)


def _heliostat(name, index, position, rng, surface=None, kinematics=False, actuators=None) -> dict:
    return dict(
        name=name,
        index=index,
        position=np.array(position + [1.0]),
        surface=None if surface is None else _surface(surface, rng),
        deviations=rng.normal(0.0, 1e-3, 13) if kinematics else None,
        orientation=np.array([0.0, -1.0, 0.0, 0.0]) + np.r_[rng.normal(0.0, 1e-3, 3), 0.0] if kinematics else None,
        actuators=actuators,
    )


def _spec(case: str, seed: int = 3) -> dict:
    rng = np.random.RandomState(seed)
    spec = dict(
        power_plant=np.array([50.91342112259258, 6.387824755874856, 87.0]),
        planar=[("receiver", np.array([0.0, -3.0, 45.0, 1.0]), np.array([0.0, 1.0, 0.0, 0.0]), 8.0, 7.0)],
        cylindrical=[],
        suns=[("sun_1", 10, 0.0, 4.3681e-06)],
        prototype_surface=_surface("planar", rng),
        prototype_actuators="linear",
    )
    if case == "prototype_only":
        spec["heliostats"] = [
            _heliostat(f"H{i:02d}", i, [8.0 * i - 8.0, 25.0 + i, 1.7], rng) for i in range(3)
        ]
    elif case == "individual":
        spec["suns"].append(("sun_2", 7, 1e-4, 1e-5))
        spec["heliostats"] = [
            _heliostat("AA39", 0, [-4.0, 25.0, 1.7], rng, "fitted", True, "linear"),
            _heliostat("AB40", 1, [4.0, 25.0, 1.7], rng, "planar", False, "linear_without_parameters"),
            _heliostat("AC41", 2, [0.0, 37.0, 1.7], rng, None, True, None),
        ]
    elif case == "two_groups":
        spec["heliostats"] = [
            _heliostat("AC03", 0, [0.0, 37.0, 1.7], rng, "fitted", False, "ideal"),
            _heliostat("AA01", 1, [-4.0, 25.0, 1.7], rng, None, True, None),
            _heliostat("AB02", 2, [4.0, 25.0, 1.7], rng, "planar", False, "ideal"),
            _heliostat("AD04", 3, [-8.0, 37.0, 1.7], rng, "fitted", True, "linear"),
        ]
    elif case == "cylindrical":
        spec["cylindrical"] = [
            ("receiver_cylinder", np.array([0.0, 0.0, 40.0, 1.0]), np.array([0.0, 0.0, 1.0, 0.0]),
             np.array([0.0, 1.0, 0.0, 0.0]), 3.0, 6.0, np.pi / 2),
        ]
        spec["heliostats"] = [_heliostat(f"H{i:02d}", i, [4.0 * i, 30.0, 1.7], rng, "fitted") for i in range(2)]
    return spec


def _actuators(module, kind: str):
    actuator_type = constants.ideal_actuator_key if kind == "ideal" else constants.linear_actuator_key
    parameters = [
        module.ActuatorParameters(
            increment=154166.67, initial_stroke_length=0.075 + 0.002 * i, offset=0.34, pivot_radius=0.32 - 0.01 * i,
            initial_angle=0.5 * i,
        )
        if kind == "linear"
        else None
        for i in range(2)
    ]
    return module.ActuatorListConfig(
        actuator_list=[
            module.ActuatorConfig(
                actuator_key=f"actuator_{i}",
                actuator_type=actuator_type,
                clockwise_axis_movement=bool(i),
                min_max_motor_positions=np.array([0, 70000 + i]),
                parameters=parameters[i],
            )
            for i in range(2)
        ]
    )


def _surface_config(module, surface: dict):
    return module.SurfaceConfig(
        facet_list=[
            module.FacetConfig(
                facet_key=f"facet_{i + 1}",
                control_points=surface["control_points"][i],
                degrees=np.array([3, 3]),
                translation_vector=surface["translations"][i],
                canting=surface["canting"][i],
            )
            for i in range(surface["control_points"].shape[0])
        ]
    )


def _generator_arguments(module, spec: dict) -> dict:
    """Either package's ``H5ScenarioGenerator`` arguments for ``spec``, built with ``module``
    (that package's ``util/config.py``)."""
    heliostats = []
    for h in spec["heliostats"]:
        kinematics = None
        if h["deviations"] is not None:
            kinematics = module.KinematicsConfig(
                initial_orientation=h["orientation"], deviations=module.KinematicsDeviations(*h["deviations"])
            )
        heliostats.append(
            module.HeliostatConfig(
                name=h["name"],
                heliostat_id=h["index"],
                position=h["position"],
                surface=None if h["surface"] is None else _surface_config(module, h["surface"]),
                kinematics=kinematics,
                actuators=None if h["actuators"] is None else _actuators(module, h["actuators"]),
            )
        )
    return dict(
        power_plant_config=module.PowerPlantConfig(power_plant_position=spec["power_plant"]),
        target_area_list_planar_config=[module.TargetAreaPlanarConfig(*t) for t in spec["planar"]],
        target_area_list_cylindrical_config=[module.TargetAreaCylindricalConfig(*t) for t in spec["cylindrical"]],
        light_source_list_config=module.LightSourceListConfig(
            light_source_list=[
                module.LightSourceConfig(key, number_of_rays=rays, mean=mean, covariance=covariance)
                for key, rays, mean, covariance in spec["suns"]
            ]
        ),
        heliostat_list_config=module.HeliostatListConfig(heliostat_list=heliostats),
        prototype_config=module.PrototypeConfig(
            surface_prototype=_surface_config(module, spec["prototype_surface"]),
            kinematics_prototype=module.KinematicsConfig(),
            actuators_prototype=_actuators(module, spec["prototype_actuators"]),
        ),
    )


def _write(directory: pathlib.Path, spec: dict) -> tuple[pathlib.Path, pathlib.Path]:
    """The scenario written by the port and by the JAX package."""
    ours = H5ScenarioGenerator(directory / "port", **_generator_arguments(config, spec)).generate_scenario()
    theirs = JaxGenerator(directory / "jax.h5", **_generator_arguments(jax_config, spec)).generate_scenario()
    return ours, theirs


def _contents(path: pathlib.Path) -> dict:
    """Every dataset of a file, by path: (dtype, shape, value), and the file's attributes."""
    items = {}

    def visit(name, node):
        if isinstance(node, h5py.Dataset):
            items[name] = (node.dtype, node.shape, node[()])
        else:
            items[name] = "group"

    with h5py.File(path, "r") as file:
        file.visititems(visit)
        items["attributes"] = dict(file.attrs)
    return items


# --------------------------------------------------------------------------- #
# Comparing scenarios.
# --------------------------------------------------------------------------- #


def _assert_same_scenario(ours, theirs, replanned: bool = False) -> None:
    """A port scenario against a JAX scenario, every field."""
    np.testing.assert_array_equal(ours.power_plant_position, np.asarray(theirs.power_plant_position))
    assert ours.power_plant_position.dtype == np.float64
    for field in dataclasses.fields(ours.solar_tower):
        mine, other = getattr(ours.solar_tower, field.name), getattr(theirs.solar_tower, field.name)
        if isinstance(mine, torch.Tensor):
            assert mine.dtype == torch.float32 and mine.device == CPU
            np.testing.assert_array_equal(mine.numpy(), np.asarray(other), err_msg=field.name)
        else:
            assert mine == other, field.name
    assert [(s.number_of_rays, s.distribution_parameters) for s in ours.light_sources] == [
        (s.number_of_rays, s.distribution_parameters) for s in theirs.light_sources
    ]
    assert ours.heliostat_group_names == theirs.heliostat_group_names
    assert len(ours.heliostat_groups) == len(theirs.heliostat_groups)
    for mine, other in zip(ours.heliostat_groups, theirs.heliostat_groups):
        for field in dataclasses.fields(mine):
            a, b = getattr(mine, field.name), getattr(other, field.name)
            if not isinstance(a, torch.Tensor):
                assert a == b, field.name
                continue
            b = np.asarray(b)
            assert a.dtype == torch.float32 and a.device == CPU and tuple(a.shape) == b.shape, field.name
            if field.name in SAMPLED_FIELDS or (replanned and field.name == "nurbs_control_points"):
                np.testing.assert_allclose(a.numpy(), b, **NURBS, err_msg=field.name)
            else:
                np.testing.assert_array_equal(a.numpy(), b, err_msg=field.name)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each case's two files: (the port's, the JAX package's)."""
    return {case: _write(tmp_path_factory.mktemp(case), _spec(case)) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_both_writers_write_the_same_file(written, case):
    ours, theirs = written[case]
    assert ours.suffix == ".h5"
    mine, other = _contents(ours), _contents(theirs)
    assert list(mine) == list(other)
    for key in mine:
        if mine[key] == "group" or key == "attributes":
            assert mine[key] == other[key], key
            continue
        (dtype, shape, value), (other_dtype, other_shape, other_value) = mine[key], other[key]
        assert dtype == other_dtype and shape == other_shape, key
        np.testing.assert_array_equal(value, other_value, err_msg=key)
    groups = 2 if case == "two_groups" else 1
    assert scenario.get_number_of_heliostat_groups_from_hdf5(ours) == groups
    assert jax_scenario.get_number_of_heliostat_groups_from_hdf5(ours) == groups


@pytest.mark.parametrize("change", [None, (5, 4)], ids=["as_written", "replanned"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_both_loaders_agree_on_either_file(written, case, change, writer):
    path = written[case][0 if writer == "port" else 1]
    ours = scenario.load_scenario_from_hdf5(
        path, number_of_surface_points_per_facet=POINTS, change_number_of_control_points_per_facet=change, device="cpu"
    )
    theirs = jax_scenario.load_scenario_from_hdf5(
        path, number_of_surface_points_per_facet=POINTS, change_number_of_control_points_per_facet=change
    )
    _assert_same_scenario(ours, theirs, replanned=change is not None)
    spec = _spec(case)
    assert sum(g.number_of_heliostats for g in ours.heliostat_groups) == len(spec["heliostats"])
    if change is not None:
        assert all(g.nurbs_control_points.shape[2:4] == change for g in ours.heliostat_groups)


def test_group_order_follows_first_appearance_over_key_order(written):
    """h5py lists heliostats by name: AA01 (linear prototype), AB02 (ideal), AC03
    (ideal), AD04 (linear), whatever order they were written in."""
    ours = scenario.load_scenario_from_hdf5(written["two_groups"][0], POINTS, device="cpu")
    assert ours.heliostat_group_names == [
        f"{constants.rigid_body_key}_{constants.linear_actuator_key}",
        f"{constants.rigid_body_key}_{constants.ideal_actuator_key}",
    ]
    assert [g.names for g in ours.heliostat_groups] == [("AA01", "AD04"), ("AB02", "AC03")]
    ideal = ours.heliostat_groups[1]
    assert ideal.actuator_non_optimizable.shape == (2, 4, 2) and ideal.actuator_optimizable.shape == (2, 0, 0)


def test_loading_from_an_open_file_and_onto_a_device(written):
    path = written["individual"][0]
    with h5py.File(path, "r") as file:
        ours = scenario.load_scenario_from_hdf5(file, POINTS, device=torch.device("cpu"))
        assert file.id.valid  # the caller's handle stays open
    _assert_same_scenario(ours, jax_scenario.load_scenario_from_hdf5(path, POINTS))


def test_sampled_surfaces_and_their_cache(written, monkeypatch):
    """Planar control points are canted and translated, fitted ones are taken as they
    are; heliostats with the same control points, canting and translations share one
    sample (the prototype-only field samples once)."""
    calls = []
    sample = scenario.sample_surface
    monkeypatch.setattr(scenario, "sample_surface", lambda *args: calls.append(1) or sample(*args))
    scenario.load_scenario_from_hdf5(written["prototype_only"][0], POINTS, device="cpu")
    assert len(calls) == 1
    for kind in ("planar", "fitted"):
        surface = dict(_surface(kind, np.random.RandomState(5)), degrees=np.array([3, 3], np.int32))
        points, normals = sample(surface, POINTS, device="cpu")
        jax_points, jax_normals = jax_scenario.sample_surface(surface, POINTS)
        assert points.shape == (4, POINTS[0] * POINTS[1], 4)
        np.testing.assert_allclose(points.numpy(), np.asarray(jax_points), **NURBS)
        np.testing.assert_allclose(normals.numpy(), np.asarray(jax_normals), **NURBS)
        centre = points[..., :3].mean(dim=1)
        translations = torch.tensor(surface["translations"][:, :3])
        # The facets sit at their translations either way (fitted ones carry them in
        # their control points); planar ones are canted, so their normals tilt.
        assert float((centre[:, :2] - translations[:, :2]).abs().max()) < 0.05


def test_prototype_fallbacks_and_missing_parameters_are_logged(written, caplog):
    """The same operator-facing lines as the JAX package, in the same order."""
    path = written["individual"][0]
    with caplog.at_level(logging.INFO):
        scenario.load_scenario_from_hdf5(path, POINTS, device="cpu")
        ours = [r.getMessage() for r in caplog.records if r.name.startswith("artist_tpu_torch")]
        caplog.clear()
        jax_scenario.load_scenario_from_hdf5(path, POINTS)
        theirs = [r.getMessage() for r in caplog.records if r.name == "artist_tpu.scenario"]
    assert ours == theirs
    assert "Individual surface parameters not provided - loading heliostat AC41 with the surface prototype." in ours
    assert "Individual kinematics configuration not provided - loading heliostat AB40 with the kinematics prototype." in ours
    assert "No individual increment set for actuator_0 on AB40. Using default 0." in ours


def test_the_in_memory_image_reads_as_the_file(written):
    """``chip_smoke.InMemoryGroup`` over the configs' dicts gives ``_read_heliostats`` the
    records its h5py read gives, array for array (phase 15b reads fits through it)."""
    spec = _spec("two_groups")
    arguments = _generator_arguments(config, spec)
    image = {
        constants.prototype_key: arguments["prototype_config"].create_prototype_dict(),
        constants.heliostat_key: {
            h.name: h.create_heliostat_dict() for h in arguments["heliostat_list_config"].heliostat_list
        },
    }
    in_memory = scenario._read_heliostats(chip_smoke.InMemoryGroup(image))
    with h5py.File(written["two_groups"][0], "r") as file:
        from_file = scenario._read_heliostats(file)

    def assert_same(a, b, where):
        assert type(a) is type(b), where
        if isinstance(a, dict):
            assert list(a) == list(b), where
            for key in a:
                assert_same(a[key], b[key], f"{where}/{key}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                assert_same(x, y, f"{where}[{i}]")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, where
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert a == b, where

    assert_same(in_memory, from_file, "heliostats")


# --------------------------------------------------------------------------- #
# Error paths.
# --------------------------------------------------------------------------- #


def _corrupt_actuator_types(section: str):
    def mutate(f):
        actuators = (
            f[constants.prototype_key][constants.actuators_prototype_key]
            if section == "prototype"
            else f[constants.heliostat_key]["AA39"][constants.heliostat_actuator_key]
        )
        del actuators["actuator_1"][constants.actuator_type_key]
        actuators["actuator_1"][constants.actuator_type_key] = constants.ideal_actuator_key

    return mutate


def _replace(parent_path, key, value):
    def mutate(f):
        for parent in parent_path(f):
            del parent[key]
            parent[key] = value

    return mutate


BROKEN = {
    "kinematics_type": (
        _replace(lambda f: [f[constants.prototype_key][constants.kinematics_prototype_key]],
                 constants.kinematics_type, "hexapod"),
        "The kinematics type: hexapod is not yet implemented!",
    ),
    "actuator_type": (
        _replace(lambda f: [a for a in f[constants.prototype_key][constants.actuators_prototype_key].values()],
                 constants.actuator_type_key, "hydraulic"),
        "The actuator type: hydraulic is not yet implemented!",
    ),
    "actuator_count": (
        lambda f: f[constants.prototype_key][constants.actuators_prototype_key].__delitem__("actuator_1"),
        "wrong amount of actuators",
    ),
    "light_source_type": (
        _replace(lambda f: list(f[constants.light_source_key].values()), constants.light_source_type, "laser"),
        "Unknown light source type: laser",
    ),
    "sun_distribution": (
        _replace(
            lambda f: [s[constants.light_source_distribution_parameters] for s in f[constants.light_source_key].values()],
            constants.light_source_distribution_type, "uniform",
        ),
        "sun distribution type",
    ),
    "prototype_actuators_mixed": (_corrupt_actuator_types("prototype"), "Prototype actuators must all have the same type."),
    "individual_actuators_mixed": (
        _corrupt_actuator_types("individual"),
        "When using the rigid body kinematics, all actuators for a given heliostat must have the same type.",
    ),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_scenarios_raise_as_in_jax(written, tmp_path, case):
    mutate, message = BROKEN[case]
    path = tmp_path / "broken.h5"
    shutil.copy(written["individual"][0], path)
    with h5py.File(path, "r+") as file:
        mutate(file)
    with pytest.raises(ValueError) as ours:
        scenario.load_scenario_from_hdf5(path, POINTS, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_scenario.load_scenario_from_hdf5(path, POINTS)
    assert message in str(ours.value)
    assert str(ours.value) == str(theirs.value)


def test_generator_refuses_what_jax_refuses(tmp_path):
    arguments = _generator_arguments(config, _spec("individual"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        H5ScenarioGenerator(tmp_path / "missing" / "scenario.h5", **arguments)
    arguments["heliostat_list_config"].heliostat_list[0].surface.facet_list.pop()
    with pytest.raises(ValueError, match="same number of facets"):
        H5ScenarioGenerator(tmp_path / "scenario.h5", **arguments)
    jax_arguments = _generator_arguments(jax_config, _spec("individual"))
    jax_arguments["heliostat_list_config"].heliostat_list[0].surface.facet_list.pop()
    with pytest.raises(ValueError, match="same number of facets"):
        JaxGenerator(tmp_path / "scenario.h5", **jax_arguments)


def test_other_suffixes_become_h5(tmp_path, caplog):
    arguments = _generator_arguments(config, _spec("prototype_only"))
    with caplog.at_level(logging.WARNING):
        path = H5ScenarioGenerator(tmp_path / "scenario.txt", **arguments).generate_scenario()
    assert path == tmp_path / "scenario.h5" and path.exists()
    assert "extension .txt is unsupported" in caplog.text


# --------------------------------------------------------------------------- #
# The loaded scenario, traced.
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["individual", "cylindrical"])
def test_loaded_scenarios_trace_as_in_jax(written, case):
    path = written[case][1]
    ours = scenario.load_scenario_from_hdf5(path, POINTS, device="cpu")
    theirs = jax_scenario.load_scenario_from_hdf5(path, POINTS)
    group, jax_group = ours.heliostat_groups[0], theirs.heliostat_groups[0]
    num, points = group.number_of_heliostats, group.surface_points.shape[1]
    rng = np.random.RandomState(11)
    rays, bitmap = 4, (32, 32)
    # Wider than the sun's 2.1 mrad so the spot spreads over the 32 x 32 bitmap.
    du = rng.normal(0.0, 1e-2, (num, rays, points)).astype(np.float32)
    de = rng.normal(0.0, 1e-2, (num, rays, points)).astype(np.float32)
    incident = np.broadcast_to(np.array([0.0, 1.0, 0.0, 0.0], np.float32), (num, 4))
    targets = np.zeros(num, np.int32)

    aim = get_centers_of_target_areas(ours.solar_tower, torch.tensor(targets, dtype=torch.long))
    aligned = hg.align_surfaces_with_incident_ray_directions(group, aim, torch.tensor(incident))[:2]
    with torch.no_grad():
        mine = render.trace_rays(
            ours.solar_tower, *aligned, torch.tensor(incident), torch.tensor(targets, dtype=torch.long),
            torch.tensor(du), torch.tensor(de), config=render.RenderConfig(bitmap_resolution=bitmap),
        )
    jax_aim = jax_centers(theirs.solar_tower, jnp.asarray(targets))
    jax_aligned = jax_hg.align_surfaces_with_incident_ray_directions(jax_group, jax_aim, jnp.asarray(incident))[:2]
    other = jax_render.trace_rays(
        theirs.solar_tower, *jax_aligned, jnp.asarray(incident), jnp.asarray(targets), jnp.asarray(du),
        jnp.asarray(de), config=jax_render.RenderConfig(bitmap_resolution=bitmap, splat_method="scatter"),
    )
    flux, jax_flux = mine[0].numpy(), np.asarray(other[0])
    assert flux.shape == (num, bitmap[1], bitmap[0]) and np.count_nonzero(flux) > 100
    np.testing.assert_allclose(flux, jax_flux, rtol=0, atol=1e-4 * jax_flux.max())
    for a, b in zip(mine[1:], other[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)

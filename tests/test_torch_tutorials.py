"""The port's tutorials (``artist_tpu_torch/tutorials``) against the JAX package's scripts.

The data are written here from a numpy seed: PAINT tower and heliostat JSON files
(``test_torch_paint_parser``'s tower, ``chip_smoke.write_paint_heliostat``'s
heliostats: AA39's linear actuators, on a grid north of the tower, from which each
can aim at the targets with the sun in the south), calibration samples of heliostat AA39
under the scripts' names (``AA39-calibration-properties_<i>.json``,
``AA39-flux-centered_<i>.png``; motor positions that aim the heliostat at the
receiver under each sample's sun, off by up to 300 steps as a real heliostat's
are, the focal spot at the receiver's centre) and
the scenario files, written by the JAX package's ``H5ScenarioGenerator``.

Each JAX script runs with ``runpy.run_path`` under ``monkeypatch``: its loader
reads these files at narrow widths (8 x 8 points a facet), its PAINT paths are
taken by file name from the test's directory, ``enable_compilation_cache`` does
nothing and ``matplotlib.pyplot`` cannot be imported (so tutorial 01 writes no
plot). Both packages draw the sun's distortions from the same numpy stream
(:class:`DistortionStream`): the n-th draw of either package is the same array.
Tutorials 03-05 run 50, 100 and 40 epochs; here the optimizers' ``max_epoch`` is
cut to :data:`EPOCHS` in both packages (the JAX optimizer classes are patched to
cut it). Tutorials 00a and 00b write their scenario under a fixed path outside
the test's directory, so the test replicates their calls instead, and cuts the
STRAL fit to 40 epochs.

Tolerances, each the one the port's tests already use for the same function:

- tutorial 01's and 02's flux: each map's sum to 1e-6 relative, each pixel to
  1e-3 of the flux peak: the two packages' aligned points lie an fp32 ulp apart
  (3.8e-6 m, 40-56 m from the tower), which moves a ray's hit by ~1e-4 of a 3 cm
  pixel, and a pixel sums a few such deposits at 4 rays a point (measured up to
  7.8e-4 of the peak); motor positions 1e-2 steps of ~4e4 (fp32); intercept
  factors to 1e-6 (ray counts);
- the scenario files: every array equal but the surfaces: ideal control points
  and the points sampled from them within 2e-6 m (both packages'
  ``create_planar_nurbs_control_points`` round their linspaces an fp32 ulp
  apart), fitted ones within 5e-6 m (``test_torch_surface_generator.py``'s
  small fit);
- surface reconstruction: epoch 0's loss terms as
  ``test_torch_surface_reconstructor.py`` holds them (1e-3 relative, the flux
  integral 1e-4 and its constraint 1e-5 absolute). Later epochs and the test
  losses are not compared: Adam moves every control point by about the rate
  whatever its gradient's size, and on this scene (a receiver 45 m away, 256 x
  256 maps) a step of 1e-4 m moves the loss by 2%, so entries whose gradient
  lies within the packages' per-pixel noise part the runs (measured: 6% at
  epoch 1);
- kinematics reconstruction (alignment): histories 2e-3 relative (an fp32 ulp of
  the dots near 1 moves the angle by 1.2e-3 of itself), test losses 1e-3
  (``test_torch_kinematics_reconstructor.py``);
- aim point: epoch 0's losses 1e-4 relative, its penalties (relative gaps to
  references taken at epoch 0: 0 in the port, ~1e-5 in JAX) 1e-4 absolute, the
  factors 1e-4; nothing
  blocks on this field (every blocking factor is 1 in both packages), so JAX's
  dense CPU route and the port's compacted one compute the same function
  (``test_torch_aim_point.py`` allows their gap only where something blocks).
  The later epochs are not compared: on the trapezoid's plateau some motor
  gradients lie within the packages' per-pixel noise, and Adam's first steps
  (the rate times the gradient's sign) then go either way (measured: one motor
  63 steps up in one package, down in the other);
- tutorial 06: the port's two forked gloo ranks equal its world of one bit for
  bit (the CPU runs the same operations on each group), and that world of one
  the JAX script's within the surface reconstructor's 1e-3.
"""

import dataclasses
import json
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import chip_smoke
from artist_tpu.io import calibration as jax_calibration
from artist_tpu.io import paint_scenario_parser as jax_paint
from artist_tpu.io.stral import extract_stral_deflectometry_data as jax_extract_stral
from artist_tpu.optim import aim_point_optimizer as jax_aim_point
from artist_tpu.optim import kinematics_reconstructor as jax_kinematics
from artist_tpu.optim import surface_reconstructor as jax_surface
from artist_tpu.scenario import h5_generator as jax_h5_generator
from artist_tpu.scenario import scenario as jax_scenario_module
from artist_tpu.scenario import surface_generator as jax_surface_generator
from artist_tpu.scene import sun as jax_sun
from artist_tpu.util import config as jax_config
from artist_tpu.util import logging_utils as jax_logging_utils
import artist_tpu.scenario as jax_scenario_package
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.io.calibration import PaintCalibrationDataParser
from artist_tpu_torch.scenario.scenario import load_scenario_from_hdf5, load_scenario_from_image
from artist_tpu_torch.tutorials import (
    aim_point_optimization,
    field_raytracing_sharded,
    generate_scenario_from_paint,
    generate_scenario_from_stral,
    kinematics_reconstruction,
    multi_process_reconstruction,
    single_heliostat_raytracing,
    surface_reconstruction,
)
from artist_tpu_torch.util import constants
from test_torch_paint_parser import write_tower

REPO = pathlib.Path(__file__).resolve().parent.parent
TUTORIALS = REPO / "tutorials"
HELIOSTATS = ("AA39", "AB40", "AC41", "AD42")
PLACES = chip_smoke.TUTORIAL_PLACES  # east, north (m)
SAMPLES = 3
RAYS = 16
POINTS = (8, 8)
EPOCHS = 2  # max_epoch of the cut optimizers: 3 epochs
CALIBRATION_TARGET = "solar_tower_juelich_upper"
SIGMA = 4.3681e-06**0.5
FLUX_SHARE = 1e-3
# The aim point's epoch 0: the losses to 1e-4 relative; the penalties, relative gaps to
# references taken at epoch 0 (0 in the port, ~1e-5 in JAX, whose references come from
# another compiled program than its step), to 1e-4 absolute, the flux integrals' tolerance.
AIM_POINT_EPOCH_0 = {"total_loss": dict(rtol=1e-4, atol=0), "flux_loss": dict(rtol=1e-4, atol=0)}
AIM_POINT_PENALTY = dict(rtol=0, atol=1e-4)


class DistortionStream:
    """Sun distortions from ``numpy.random.RandomState(seed)``: each draw ``[M, R, P]``
    pairs of normal angles, so two streams of one seed give both packages the same
    arrays, draw by draw."""

    def __init__(self, number_of_rays: int, seed: int = 11):
        self.number_of_rays = number_of_rays
        self.rng = np.random.RandomState(seed)

    def draw(self, number_of_points: int, number_of_active_heliostats: int) -> tuple[np.ndarray, np.ndarray]:
        shape = (number_of_active_heliostats, self.number_of_rays, number_of_points)
        return tuple((SIGMA * self.rng.standard_normal(shape)).astype(np.float32) for _ in range(2))

    def get_distortions(self, generator, number_of_points: int, number_of_active_heliostats: int):
        """The port's light-source interface."""
        device = generator.device if generator is not None else "cpu"
        return tuple(torch.tensor(x, device=device) for x in self.draw(number_of_points, number_of_active_heliostats))


def jax_draws(monkeypatch, seed: int = 11) -> None:
    """Make every JAX ``Sun`` draw from a :class:`DistortionStream` of ``seed``."""
    streams = {}

    def get_distortions(sun, key, number_of_points, number_of_active_heliostats):
        stream = streams.setdefault(sun.number_of_rays, DistortionStream(sun.number_of_rays, seed))
        return tuple(jnp.asarray(x) for x in stream.draw(number_of_points, number_of_active_heliostats))

    monkeypatch.setattr(jax_sun.Sun, "get_distortions", get_distortions)


def write_calibration_samples(directory: pathlib.Path, heliostat: str, count: int, seed: int, rays: int) -> None:
    """``count`` calibration samples of ``heliostat`` under the PAINT names, their motor
    positions aiming it at :data:`CALIBRATION_TARGET`'s centre under each sample's sun
    (solved by the port on the CPU), and a flux PNG each (a Gaussian spot)."""
    rng = np.random.RandomState(seed)
    tower = json.loads((directory / "tower-measurements.json").read_text())
    centre = tower[CALIBRATION_TARGET]["coordinates"]["center"]
    generator = generate_scenario_from_paint.paint_scenario_generator(
        directory / "tower-measurements.json",
        [(heliostat, directory / f"{heliostat}-heliostat-properties.json")],
        directory / "unused.h5",
        number_of_rays=rays,
    )
    scenario = load_scenario_from_image(generator.scenario_image(), POINTS, device="cpu")
    paths = []
    for i in range(1, count + 1):
        path = directory / f"{heliostat}-calibration-properties_{i}.json"
        spot = [c + rng.normal(0, 1e-7) for c in centre]
        path.write_text(json.dumps({
            "motor_position": {"axis_1_motor_position": 0, "axis_2_motor_position": 0},
            "target_name": CALIBRATION_TARGET,
            "sun_azimuth": float(rng.uniform(-50, 50)),
            "sun_elevation": float(rng.uniform(25, 55)),
            "focal_spot": {"UTIS": spot, "HeliOS": spot},
        }))
        paths.append(path)
        yy, xx = np.mgrid[0:48, 0:64]
        image = np.exp(-((xx / 64 - rng.uniform(0.4, 0.6)) ** 2 + (yy / 48 - rng.uniform(0.4, 0.6)) ** 2) / 0.01)
        Image.fromarray((255 * image).astype(np.uint8), "L").save(directory / f"{heliostat}-flux-centered_{i}.png")
    tower_state = scenario.solar_tower
    data = PaintCalibrationDataParser().parse_data_for_reconstruction(
        [(heliostat, paths, [directory / f"{heliostat}-flux-centered_{i}.png" for i in range(1, count + 1)])],
        (heliostat,), tower_state.target_name_to_index, scenario.power_plant_position, (32, 32),
    )
    targets = torch.as_tensor(data.target_area_indices, dtype=torch.long)
    motors = hg.align_surfaces_with_incident_ray_directions(
        hg.gather_active(scenario.heliostat_groups[0], torch.zeros(count, dtype=torch.long)),
        get_centers_of_target_areas(tower_state, targets),
        torch.as_tensor(data.incident_ray_directions),
    )[3].numpy()
    for path, motor in zip(paths, motors):
        properties = json.loads(path.read_text())
        motor = motor + rng.uniform(-300, 300, 2)
        properties["motor_position"] = {"axis_1_motor_position": int(round(motor[0])),
                                        "axis_2_motor_position": int(round(motor[1]))}
        path.write_text(json.dumps(properties))


def write_jax_scenario(directory: pathlib.Path, path: pathlib.Path, heliostats, rays: int) -> pathlib.Path:
    """The JAX package's scenario file of ``heliostats`` on ideal 7 x 7 surfaces."""
    power_plant, planar, cylindrical = jax_paint.extract_paint_tower_measurements(directory / "tower-measurements.json")
    heliostat_list, prototype = jax_paint.extract_paint_heliostats_ideal_surface(
        paths=[(name, directory / f"{name}-heliostat-properties.json") for name in heliostats],
        power_plant_position=power_plant.power_plant_position,
        number_of_nurbs_control_points=(7, 7),
    )
    jax_h5_generator.H5ScenarioGenerator(
        file_path=path, power_plant_config=power_plant, target_area_list_planar_config=planar,
        target_area_list_cylindrical_config=cylindrical,
        light_source_list_config=jax_config.LightSourceListConfig(
            light_source_list=[jax_config.LightSourceConfig(light_source_key="sun_1", number_of_rays=rays)]
        ),
        heliostat_list_config=heliostat_list, prototype_config=prototype,
    ).generate_scenario()
    return path


def write_paint_field(directory: pathlib.Path, heliostats=HELIOSTATS, samples: int = SAMPLES, rays: int = RAYS,
                      seed: int = 0) -> pathlib.Path:
    """The PAINT files of ``heliostats`` (the first with ``samples`` calibration samples)
    and the tower in ``directory``."""
    directory.mkdir(parents=True, exist_ok=True)
    write_tower(directory / "tower-measurements.json", seed)
    for i, name in enumerate(heliostats):
        chip_smoke.write_paint_heliostat(directory / f"{name}-heliostat-properties.json", *PLACES[i], seed + 10 + i)
    write_calibration_samples(directory, heliostats[0], samples, seed + 5, rays)
    return directory


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """The PAINT directory, and the JAX package's one-heliostat and four-heliostat files."""
    base = tmp_path_factory.mktemp("tutorials")
    data = write_paint_field(base / "field_data")
    return dict(
        data=data,
        single=write_jax_scenario(data, base / "single.h5", HELIOSTATS[:1], RAYS),
        four=write_jax_scenario(data, base / "four.h5", HELIOSTATS, RAYS),
    )


@pytest.fixture
def scripts(monkeypatch, field):
    """The JAX scripts' environment: their loader reads the test's files at
    :data:`POINTS`, their PAINT paths are taken by name from the test's directory, no
    compilation cache, no plot, numpy distortions. Returns ``run(name)``, the
    script's globals after it ran."""
    jax_load = jax_scenario_module.load_scenario_from_hdf5

    def load(path, number_of_surface_points_per_facet=None, **kwargs):
        own = field["single"] if "single_heliostat" in pathlib.Path(path).name else field["four"]
        return jax_load(own, number_of_surface_points_per_facet=POINTS, **kwargs)

    class Parser(jax_calibration.PaintCalibrationDataParser):
        def parse_data_for_reconstruction(self, heliostat_data_mapping, **kwargs):
            mapping = [
                (name, [field["data"] / pathlib.Path(p).name for p in properties],
                 [field["data"] / pathlib.Path(p).name for p in pngs])
                for name, properties, pngs in heliostat_data_mapping
            ]
            return super().parse_data_for_reconstruction(heliostat_data_mapping=mapping, **kwargs)

    monkeypatch.setattr(jax_scenario_package, "load_scenario_from_hdf5", load)
    monkeypatch.setattr(jax_calibration, "PaintCalibrationDataParser", Parser)
    monkeypatch.setattr(jax_logging_utils, "enable_compilation_cache", lambda *args, **kwargs: None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    jax_draws(monkeypatch)
    for module, name in ((jax_surface, "SurfaceReconstructor"), (jax_kinematics, "KinematicsReconstructor"),
                         (jax_aim_point, "AimPointOptimizer")):
        monkeypatch.setattr(module, name, cut_epochs(getattr(module, name)))
    return lambda name: runpy.run_path(str(TUTORIALS / name), run_name="tutorial")


def cut_epochs(cls):
    """``cls`` whose optimization configuration runs at most :data:`EPOCHS` + 1 epochs."""

    class Cut(cls):
        def __init__(self, *args, optimization_configuration, **kwargs):
            super().__init__(*args, optimization_configuration=cut(optimization_configuration), **kwargs)

    return Cut


def cut(configuration: dict) -> dict:
    configuration = {key: dict(value) for key, value in configuration.items()}
    configuration[constants.optimization][constants.max_epoch] = EPOCHS
    return configuration


def port_scenario(path, points=POINTS, **kwargs):
    """The port's scenario of a file on the CPU, its sun a :class:`DistortionStream`."""
    scenario = load_scenario_from_hdf5(path, number_of_surface_points_per_facet=points, device="cpu", **kwargs)
    scenario.light_sources[0] = DistortionStream(scenario.light_sources[0].number_of_rays)
    return scenario


def assert_flux_close(ours: torch.Tensor, theirs) -> None:
    theirs = np.asarray(theirs)
    assert theirs.max() > 0
    np.testing.assert_allclose(ours.sum(dim=(-2, -1)).numpy(), theirs.sum(axis=(-2, -1)), rtol=1e-6)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=FLUX_SHARE * theirs.max())


# --------------------------------------------------------------------------- #
# Tutorials 00a and 00b: scenario files.
# --------------------------------------------------------------------------- #


IDEAL_SURFACE_ATOL = 2e-6
FITTED_SURFACE_ATOL = 5e-6


def assert_same_scenario_files(ours: pathlib.Path, theirs: pathlib.Path,
                               surface_atol: float = IDEAL_SURFACE_ATOL) -> None:
    """Both packages' loaders read both files alike: each package's loads of the two
    files hold equal arrays (the surfaces within ``surface_atol``)."""
    first, second = (load_scenario_from_hdf5(p, POINTS, device="cpu") for p in (ours, theirs))
    assert first.heliostat_group_names == second.heliostat_group_names
    np.testing.assert_array_equal(first.power_plant_position, second.power_plant_position)
    for a, b in zip(first.heliostat_groups, second.heliostat_groups):
        assert a.names == b.names
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if not isinstance(x, torch.Tensor):
                assert x == y, f.name
            elif f.name in ("nurbs_control_points", "surface_points", "surface_normals"):
                torch.testing.assert_close(x, y, rtol=0, atol=surface_atol, msg=f.name)
            else:
                torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f.name)
    jax_first, jax_second = (jax_scenario_module.load_scenario_from_hdf5(p, POINTS) for p in (ours, theirs))
    for a, b in zip(jax_first.heliostat_groups, jax_second.heliostat_groups):
        np.testing.assert_allclose(np.asarray(a.nurbs_control_points), np.asarray(b.nurbs_control_points),
                                   rtol=0, atol=surface_atol)
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))


def test_generate_scenario_from_paint_matches_jax(field, tmp_path):
    data = field["data"]
    files = [("AA39", data / "AA39-heliostat-properties.json")]
    ours = generate_scenario_from_paint.paint_scenario_generator(data / "tower-measurements.json", files,
                                                                 tmp_path / "ours.h5").generate_scenario()
    # The script's calls (tutorials/00_generate_scenario_from_paint.py:37-61), at its widths.
    theirs = write_jax_scenario(data, tmp_path / "theirs.h5", ["AA39"], 100)
    assert_same_scenario_files(ours, theirs)
    assert generate_scenario_from_paint.main(
        ["--tower", str(data / "tower-measurements.json"), "--heliostat", f"AA39={files[0][1]}",
         "--output", str(tmp_path / "cli.h5")]
    ) == tmp_path / "cli.h5"
    assert_same_scenario_files(tmp_path / "cli.h5", theirs)


def write_jax_stral_scenario(stral: pathlib.Path, path: pathlib.Path, max_epoch: int) -> pathlib.Path:
    """The script's calls (``tutorials/00_generate_scenario_from_stral.py:42-112``), the
    fit cut to ``max_epoch`` epochs."""
    facet_translations, canting, points, normals = jax_extract_stral(stral)
    surface = jax_surface_generator.SurfaceGenerator(number_of_control_points=(10, 10)).generate_fitted_surface_config(
        heliostat_name="heliostat_1", facet_translation_vectors=facet_translations, canting=canting,
        surface_points_with_facets_list=points, surface_normals_with_facets_list=normals,
        deflectometry_step_size=100, fit_method=constants.fit_nurbs_from_normals, max_epoch=max_epoch,
    )
    actuators = jax_config.ActuatorListConfig(actuator_list=[
        jax_config.ActuatorConfig(
            actuator_key=f"actuator_{i}", actuator_type=constants.linear_actuator_key, clockwise_axis_movement=bool(i),
            min_max_motor_positions=np.array([0, 70000]),
            parameters=jax_config.ActuatorParameters(
                increment=154166.67, initial_stroke_length=0.075, offset=0.34, pivot_radius=0.32, initial_angle=0.5
            ),
        )
        for i in range(2)
    ])
    jax_h5_generator.H5ScenarioGenerator(
        file_path=path,
        power_plant_config=jax_config.PowerPlantConfig(power_plant_position=np.array([50.91342, 6.38782, 87.0])),
        target_area_list_planar_config=[jax_config.TargetAreaPlanarConfig(
            target_area_key="receiver", center=np.array([0.0, -3.0, 45.0, 1.0]),
            normal_vector=np.array([0.0, 1.0, 0.0, 0.0]), plane_e=8.0, plane_u=7.0,
        )],
        target_area_list_cylindrical_config=[],
        light_source_list_config=jax_config.LightSourceListConfig(
            light_source_list=[jax_config.LightSourceConfig(light_source_key="sun_1", number_of_rays=100)]
        ),
        heliostat_list_config=jax_config.HeliostatListConfig(heliostat_list=[
            jax_config.HeliostatConfig(name="heliostat_1", heliostat_id=1, position=np.array([10.0, 30.0, 1.7, 1.0]))
        ]),
        prototype_config=jax_config.PrototypeConfig(
            surface_prototype=surface, kinematics_prototype=jax_config.KinematicsConfig(),
            actuators_prototype=actuators,
        ),
    ).generate_scenario()
    return path


def test_generate_scenario_from_stral_matches_jax(tmp_path):
    stral = tmp_path / "heliostat.binp"
    chip_smoke.write_ingress_stral(stral, 0, 20_000, chip_smoke.ingress_dents(1)[0])
    ours = generate_scenario_from_stral.stral_scenario_generator(
        stral, tmp_path / "ours.h5", max_epoch=40, device="cpu"
    ).generate_scenario()
    theirs = write_jax_stral_scenario(stral, tmp_path / "theirs.h5", 40)
    assert_same_scenario_files(ours, theirs, FITTED_SURFACE_ATOL)


# --------------------------------------------------------------------------- #
# Tutorials 01 and 02: ray tracing.
# --------------------------------------------------------------------------- #


def test_single_heliostat_raytracing_matches_jax(field, scripts):
    theirs = scripts("01_single_heliostat_raytracing.py")
    ours = single_heliostat_raytracing.render_single_heliostat(port_scenario(field["single"]), device="cpu")
    assert ours["name"] == "AA39"
    assert_flux_close(ours["flux"], theirs["flux"])
    np.testing.assert_allclose(ours["motor_positions"].numpy(), np.asarray(theirs["motor_positions"]), rtol=0,
                               atol=1e-2)
    for key, name in (("intercept", "intercept"), ("on_target", "on_target")):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[name]), rtol=0, atol=1e-6)
    assert float(ours["intercept"][0]) > 0.5


def test_single_heliostat_raytracing_command_line(field, capsys):
    result = single_heliostat_raytracing.main(["--scenario", str(field["single"]), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Total flux" in printed and "intercept factor" in printed
    assert result["flux"].shape == (1, 256, 256) and torch.isfinite(result["flux"]).all()


def test_field_raytracing_matches_jax(field, scripts):
    theirs = scripts("02_field_raytracing_sharded.py")
    scenario = port_scenario(field["four"])
    # The JAX script's mesh pads the heliostat axis to its 4 x 2 mesh of the 8 CPU
    # devices; 4 heliostats need no padding, so both packages draw [4, R, P].
    ours = field_raytracing_sharded.render_field(scenario, device="cpu")
    assert_flux_close(ours["total_flux_per_target"], theirs["total_flux_per_target"])
    assert ours["heliostats"] == [4]
    np.testing.assert_allclose(ours["mean_intercepts"], [float(jnp.mean(theirs["intercept"][:4]))], rtol=0, atol=1e-6)


def test_field_raytracing_on_a_mesh_of_one_equals_no_mesh(field):
    """A caller's process group and mesh (a world of one on gloo): the same flux."""
    from artist_tpu_torch.parallel import setup_distributed_environment

    plain = field_raytracing_sharded.render_field(port_scenario(field["four"]), device="cpu")
    with setup_distributed_environment(1, device="cpu") as setup:
        meshed = field_raytracing_sharded.render_field(port_scenario(field["four"]), mesh=setup.mesh, device="cpu")
    torch.testing.assert_close(meshed["total_flux_per_target"], plain["total_flux_per_target"], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# Tutorials 03-05: the three optimizers, cut to EPOCHS.
# --------------------------------------------------------------------------- #


def test_surface_reconstruction_matches_jax(field, scripts):
    theirs = scripts("03_surface_reconstruction.py")
    scenario = port_scenario(field["four"], change_number_of_control_points_per_facet=(7, 7))
    final, results = surface_reconstruction.reconstruct_surfaces(
        scenario, PaintCalibrationDataParser(), surface_reconstruction.heliostat_data_mapping(field["data"]),
        configuration=cut(surface_reconstruction.optimization_configuration()), device="cpu",
    )
    (result,), (jax_result,) = results, theirs["results"]
    assert set(result.loss_history) == set(jax_result.loss_history)
    for key, values in jax_result.loss_history.items():
        assert len(result.loss_history[key]) == len(values) == EPOCHS + 1, key
        assert np.isfinite(result.loss_history[key]).all(), key
        atol = {"flux_integral": 1e-4, "flux_integral_constraint": 1e-5}.get(key, 1e-9)
        rtol = 0 if key in ("flux_integral", "flux_integral_constraint") else 1e-3
        np.testing.assert_allclose(result.loss_history[key][0], values[0], rtol=rtol, atol=atol, err_msg=key)
    # Heliostats without samples keep an infinite final loss in both packages.
    np.testing.assert_array_equal(np.isfinite(final), np.isfinite(np.asarray(theirs["final_loss"])))
    assert np.isfinite(final[0])
    assert set(result.test_loss) == set(jax_result.test_loss)
    assert all(np.isfinite(value).all() for value in result.test_loss.values())
    assert surface_reconstruction.describe(results)[0].startswith("Group 0: loss ")


def test_kinematics_reconstruction_matches_jax(field, scripts):
    theirs = scripts("04_kinematics_reconstruction.py")
    final, results = kinematics_reconstruction.reconstruct_kinematics(
        port_scenario(field["four"]), PaintCalibrationDataParser(),
        surface_reconstruction.heliostat_data_mapping(field["data"]),
        configuration=cut(kinematics_reconstruction.optimization_configuration()), device="cpu",
    )
    (result,), (jax_result,) = results, theirs["results"]
    assert len(result.loss_history) == EPOCHS + 1
    np.testing.assert_allclose(result.loss_history, jax_result.loss_history, rtol=2e-3)
    finite = np.isfinite(np.asarray(theirs["final_loss"]))
    np.testing.assert_allclose(final[finite], np.asarray(theirs["final_loss"])[finite], rtol=2e-3)
    for key, values in jax_result.test_loss.items():
        np.testing.assert_allclose(result.test_loss[key], np.asarray(values), rtol=1e-3, err_msg=key)
    assert "alignment loss" in kinematics_reconstruction.describe(results)[0]


def test_aim_point_optimization_matches_jax(field, scripts):
    theirs = scripts("05_aim_point_optimization.py")
    scenario = port_scenario(field["four"])
    final, history, intercepts, on_targets, blockings = aim_point_optimization.optimize_aim_points(
        scenario, configuration=cut(aim_point_optimization.optimization_configuration()), device="cpu"
    )
    assert float(blockings.min()) == 1.0 and float(np.min(theirs["blockings"])) == 1.0
    assert len(history["total_loss"]) == EPOCHS + 1
    for key, values in theirs["history"].items():
        np.testing.assert_allclose(history[key][0], values[0], **AIM_POINT_EPOCH_0.get(key, AIM_POINT_PENALTY),
                                   err_msg=key)
        assert np.isfinite(history[key]).all(), key
    for mine, other in ((intercepts, theirs["intercepts"]), (on_targets, theirs["on_targets"])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        aim_point_optimization.trapezoid_ground_truth(), np.asarray(theirs["ground_truth"]), rtol=0, atol=1e-6
    )


# --------------------------------------------------------------------------- #
# Tutorial 06: two processes.
# --------------------------------------------------------------------------- #


def test_multi_process_reconstruction_matches_jax(monkeypatch, capfd):
    """The port's ``fork`` mode (two gloo ranks on a free port, as
    ``tests/test_torch_distributed.py`` spawns them) against its world of one, and its
    world of one, on JAX's script's numpy distortions, against the JAX script's."""
    assert multi_process_reconstruction.main(["fork", "--device", "cpu"]) == 0
    out, decoder = capfd.readouterr().out, json.JSONDecoder()
    # The ranks print at once, so their lines may interleave: decode each object where it starts.
    ranks = [decoder.raw_decode(out, start)[0] for start in range(len(out)) if out.startswith('{"rank"', start)]
    assert sorted(r["rank"] for r in ranks) == [0, 1] and all(r["world_size"] == 2 for r in ranks)
    single = multi_process_reconstruction.run(device="cpu")
    assert single["world_size"] == 1 and single["groups"] == [0, 1]
    for rank in ranks:
        assert rank["groups"] == [0, 1]
        np.testing.assert_array_equal(rank["final_loss"], single["final_loss"])

    jax_draws(monkeypatch)
    recorded = []

    class Recording(jax_surface.SurfaceReconstructor):
        def reconstruct_surfaces(self, *args, **kwargs):
            recorded.append(super().reconstruct_surfaces(*args, **kwargs))
            return recorded[-1]

    monkeypatch.setattr(jax_surface, "SurfaceReconstructor", Recording)
    monkeypatch.setenv("XLA_FLAGS", "")
    script = runpy.run_path(str(TUTORIALS / "06_multi_process_reconstruction.py"), run_name="tutorial")
    script["run"](None, 1, 0)
    scenario = multi_process_reconstruction.tutorial_scenario("cpu")
    scenario.light_sources[0] = DistortionStream(scenario.light_sources[0].number_of_rays)
    final, results = multi_process_reconstruction.reconstruct(scenario)
    jax_final, jax_results = recorded[0]
    assert [r.group_index for r in results] == [r.group_index for r in jax_results] == [0, 1]
    np.testing.assert_allclose(final, np.asarray(jax_final), rtol=1e-3)
    for result, jax_result in zip(results, jax_results):
        np.testing.assert_allclose(result.loss_history["total_loss"], jax_result.loss_history["total_loss"], rtol=1e-3)

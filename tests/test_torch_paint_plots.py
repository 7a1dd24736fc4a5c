"""The port's PAINT plot example (``artist_tpu_torch/examples/paint_plots``) against the JAX
package's scripts (``examples/paint_plots``), on one PAINT download written here.

The download is written from a numpy seed in PAINT's layout
(``<name>/Properties/<name>-heliostat-properties.json``,
``<name>/Calibration/<id>-calibration-properties.json`` with ``<id>-flux.png``,
``<name>/Deflectometry/<name>-filled-<date>.h5``): ``test_torch_paint_parser``'s
tower, ``chip_smoke.write_paint_heliostat``'s heliostats on the tutorials' grid,
three calibration samples each in the tutorials' manner (motor positions that aim the
heliostat at the upper target under each sample's sun, off by up to 300 steps; a
Gaussian spot as the flux image) with distinct UTIS and HeliOS centroids, and
``test_torch_paint_parser``'s deflectometry clouds. One heliostat lacks the HeliOS
centroid in one file and one has a calibration without its image, so that the viable
list has something to leave out. The flux-prediction and demo tests also use
``test_torch_tutorials``'s flat directory.

The JAX scripts import each other by bare name; the test imports them from their
directory and takes them off ``sys.modules`` again. Both packages draw the sun's
distortions from the same numpy stream (``test_torch_tutorials.DistortionStream``).
Held, with the tolerances stated:

- the viable lists: equal;
- the reconstruction scenario and both flux-prediction scenarios: every array equal
  but the surfaces, ideal ones within 2e-6 m and fitted ones within 5e-6 m
  (``test_torch_tutorials.assert_same_scenario_files``); the fits cut to 40 epochs
  in both packages;
- the reconstruction results of both centroid methods, with the JAX script's focal-spot
  ground truth (the measured flux's centre of mass), at max_epoch 2: epoch 0's loss
  within 1e-3 of a pixel on the target (:data:`SPOT_PIXELS`), the positions equal, each
  heliostat's last loss within the distance Adam's steps can move a spot in either
  package (:func:`adam_bound`), as
  the optimizers part after epoch 0 (``test_torch_tutorials``). With the port's
  default ground truth, the measured focal spots, equal to the flux's centre of mass
  where the centroids are that centre, and apart where they are not;
- the flux-prediction and demo bitmaps, from the same distortions: as
  ``test_torch_tutorials`` holds the tutorials' fluxes (sums 1e-6 relative, pixels 1e-3
  of the peak), the measured images equal;
- the plot data: the arrays the JAX scripts hand matplotlib (recorded by a stand-in
  for ``pyplot``) equal to the port's, and the port's PDFs written.
"""

import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import chip_smoke
from artist_tpu.scenario import h5_generator as jax_h5_generator
from artist_tpu.scenario import scenario as jax_scenario_module
from artist_tpu.io import paint_scenario_parser as jax_paint
from artist_tpu.util import config as jax_config
from artist_tpu_torch.examples.paint_plots import (
    _config,
    download_data,
    download_metadata,
    flux_prediction_plot,
    flux_prediction_raytracing,
    flux_prediction_scenario,
    reconstruction_generate_results,
    reconstruction_generate_viable_heliostats_list,
    reconstruction_plot,
    reconstruction_scenario,
)
from artist_tpu_torch.field import heliostat_group as hg
from artist_tpu_torch.field.solar_tower import get_centers_of_target_areas
from artist_tpu_torch.flux.bitmap import get_center_of_mass
from artist_tpu_torch.geometry.coordinates import bitmap_coordinates_to_target_coordinates
from artist_tpu_torch.io.calibration import CalibrationDataParser, PaintCalibrationDataParser
from artist_tpu_torch.io.paint_scenario_parser import (
    extract_paint_deflectometry_data,
    extract_paint_heliostat_properties,
)
from artist_tpu_torch.scenario.scenario import load_scenario_from_hdf5, load_scenario_from_image
from artist_tpu_torch.scenario.surface_generator import SurfaceGenerator
from artist_tpu_torch.tutorials import generate_scenario_from_paint
from artist_tpu_torch.util import constants
from test_torch_paint_parser import write_deflectometry, write_tower
import test_torch_tutorials as tutorials
from test_torch_tutorials import (
    FITTED_SURFACE_ATOL,
    PLACES,
    DistortionStream,
    assert_flux_close,
    assert_same_scenario_files,
    jax_draws,
    write_paint_field,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_EXAMPLE = REPO / "examples" / "paint_plots"
JAX_MODULES = (
    "_config", "reconstruction_generate_viable_heliostats_list", "reconstruction_scenario",
    "reconstruction_generate_results", "flux_prediction_scenario", "flux_prediction_raytracing",
    "reconstruction_plot", "flux_prediction_plot",
)
TOWER = "WRI1030197-tower-measurements.json"
HELIOSTATS = ("AA39", "AB40", "AC41", "AD42")
SAMPLES = 3
TARGET = "solar_tower_juelich_upper"
HELIOS_OFFSET = 0.05  # m east and up of the UTIS centroid
FOR_RAYTRACING = {"AA39": 101, "AB40": 201}
FIT_EPOCHS = 40
PREDICTION_RAYS = 16
PREDICTION_POINTS = (20, 20)
# The two packages' fluxes: test_torch_tutorials' tolerance for the same trace, 1e-3 of
# the peak (its hits lie ~1e-4 of a pixel apart); measured here up to 3.5e-4.
FLUX_SHARE = tutorials.FLUX_SHARE
RATE = 1e-4  # the reconstruction's initial rate (reconstruction_generate_results.py:52)
# Epoch 0's focal-spot losses of the two packages: within 1e-3 of a pixel (3.1e-5 m on the
# 8 m target). A spot is a centre of mass over the map, and the packages' fp32 hits lie
# ~1e-4 of a pixel apart (``test_torch_tutorials``, whose fluxes agree to 1e-3 of the
# peak for the same reason); measured here: 7.3e-6 to 2.2e-5 m (6e-5 to 2e-4 of the loss).
SPOT_PIXELS = 1e-3


def paint_wgs84(tower: dict, east: float, up: float) -> list[float]:
    """The target centre of ``tower`` moved ``east`` and ``up`` m."""
    latitude, longitude, altitude = tower[TARGET]["coordinates"]["center"]
    return [latitude, longitude + east / 70_100.0, altitude + up]


def write_calibrations(directory: pathlib.Path, name: str, ids, seed: int, helios: bool = True) -> None:
    """Calibration samples ``ids`` of ``name`` in PAINT's layout (the tutorials' samples,
    ``test_torch_tutorials.write_calibration_samples``), with a UTIS centroid near the
    target's centre and a HeliOS centroid :data:`HELIOS_OFFSET` m from it (none where
    ``helios`` is False for the last sample), and a flux image each."""
    rng = np.random.RandomState(seed)
    tower = json.loads((directory / TOWER).read_text())
    calibration = directory / name / "Calibration"
    calibration.mkdir(parents=True, exist_ok=True)
    properties = directory / name / "Properties" / f"{name}-heliostat-properties.json"
    paths, images = [], []
    for k, sample in enumerate(ids):
        path = calibration / f"{sample}-calibration-properties.json"
        utis = paint_wgs84(tower, rng.normal(0, 0.2), rng.normal(0, 0.2))
        focal_spot = {"UTIS": utis}
        if helios or k < len(ids) - 1:
            focal_spot["HeliOS"] = [utis[0], utis[1] + HELIOS_OFFSET / 70_100.0, utis[2] + HELIOS_OFFSET]
        path.write_text(json.dumps({
            "motor_position": {"axis_1_motor_position": 0, "axis_2_motor_position": 0},
            "target_name": TARGET,
            "sun_azimuth": float(rng.uniform(-50, 50)),
            "sun_elevation": float(rng.uniform(25, 55)),
            "focal_spot": focal_spot,
        }))
        yy, xx = np.mgrid[0:48, 0:64]
        image = np.exp(-((xx / 64 - rng.uniform(0.4, 0.6)) ** 2 + (yy / 48 - rng.uniform(0.4, 0.6)) ** 2) / 0.01)
        images.append(calibration / f"{sample}-flux.png")
        Image.fromarray((255 * image).astype(np.uint8), "L").save(images[-1])
        paths.append(path)
    scenario = load_scenario_from_image(
        generate_scenario_from_paint.paint_scenario_generator(directory / TOWER, [(name, properties)], "unused.h5",
                                                              number_of_rays=4).scenario_image(),
        (5, 5), device="cpu",
    )
    data = PaintCalibrationDataParser().parse_data_for_reconstruction(
        [(name, paths, images)], (name,), scenario.solar_tower.target_name_to_index, scenario.power_plant_position,
        (32, 32),
    )
    targets = torch.as_tensor(data.target_area_indices, dtype=torch.long)
    motors = hg.align_surfaces_with_incident_ray_directions(
        hg.gather_active(scenario.heliostat_groups[0], torch.zeros(len(ids), dtype=torch.long)),
        get_centers_of_target_areas(scenario.solar_tower, targets),
        torch.as_tensor(data.incident_ray_directions),
    )[3].numpy()
    for path, motor in zip(paths, motors):
        record = json.loads(path.read_text())
        motor = motor + rng.uniform(-300, 300, 2)
        record["motor_position"] = {"axis_1_motor_position": int(round(motor[0])),
                                    "axis_2_motor_position": int(round(motor[1]))}
        path.write_text(json.dumps(record))


def write_paint_download(directory: pathlib.Path) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    write_tower(directory / TOWER, 0)
    for i, name in enumerate(HELIOSTATS):
        (directory / name / "Properties").mkdir(parents=True)
        chip_smoke.write_paint_heliostat(directory / name / "Properties" / f"{name}-heliostat-properties.json",
                                         *PLACES[i], 10 + i)
        ids = [100 * (i + 1) + k for k in range(1, SAMPLES + 1)]
        write_calibrations(directory, name, ids, 5 + i, helios=name != "AD42")
    # A calibration without its flux image: left out of the viable list.
    (directory / "AC41" / "Calibration" / "999-calibration-properties.json").write_text(
        (directory / "AC41" / "Calibration" / "301-calibration-properties.json").read_text()
    )
    for i, name in enumerate(FOR_RAYTRACING):
        (directory / name / "Deflectometry").mkdir(parents=True)
        for k, date in enumerate(("2022-06-01Z", "2023-06-01Z")[: 2 - i]):
            write_deflectometry(directory / name / "Deflectometry" / f"{name}-filled-{date}.h5", 20 + 3 * i + k)
    return directory


@pytest.fixture(scope="module")
def download(tmp_path_factory):
    return write_paint_download(tmp_path_factory.mktemp("paint_plots") / "paint_data")


@pytest.fixture
def jax_scripts(monkeypatch):
    """The JAX example's modules, imported by bare name from their directory."""
    monkeypatch.syspath_prepend(str(JAX_EXAMPLE))
    for name in JAX_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    modules = {name: importlib.import_module(name) for name in JAX_MODULES}
    yield modules
    for name in JAX_MODULES:
        sys.modules.pop(name, None)


def viable(download: pathlib.Path, minimum: int = SAMPLES) -> list[dict]:
    return reconstruction_generate_viable_heliostats_list.find_viable_heliostats(download, minimum, 2200, set(), "flux")


# --------------------------------------------------------------------------- #
# The configuration, the viable list and the download checks.
# --------------------------------------------------------------------------- #


def test_config_seeds_the_command_line_from_the_yaml(tmp_path, jax_scripts):
    """The port's YAML holds the JAX one's keys and values but for the three output
    directories; flags override it and relative paths resolve against the root."""
    ours, theirs = (yaml.safe_load(path.read_text()) for path in (_config.CONFIG, JAX_EXAMPLE / "paint_plot_config.yaml"))
    moved = {"scenarios_dir", "results_dir", "plots_dir"}
    assert set(ours) == set(theirs) == set(_config.DEFAULTS)
    assert {k: v for k, v in ours.items() if k not in moved} == {k: v for k, v in theirs.items() if k not in moved}
    assert set(jax_scripts["_config"].DEFAULTS) == set(_config.DEFAULTS)
    args = _config.load_config(
        ["data_dir", "minimum_number_of_measurements", "heliostats_for_raytracing", "plots_dir"], "test",
        argv=["--minimum_number_of_measurements", "4", "--plots_dir", "figures"], root=tmp_path,
    )
    assert args.minimum_number_of_measurements == 4
    assert args.data_dir == tmp_path / "paint_data" and args.plots_dir == tmp_path / "figures"
    assert args.heliostats_for_raytracing == {"AA39": 149576, "AY26": 247613, "BC34": 82084}
    other = tmp_path / "other.yaml"
    other.write_text(yaml.safe_dump({"data_dir": str(tmp_path / "elsewhere"), "random_seed": 3}))
    args = _config.load_config(["data_dir", "random_seed"], "test", argv=["--config", str(other)])
    assert args.data_dir == tmp_path / "elsewhere" and args.random_seed == 3
    with pytest.warns(UserWarning, match="not found"):
        args = _config.load_config(["random_seed"], "test", argv=["--config", str(tmp_path / "missing.yaml")])
    assert args.random_seed == 7


def test_viable_list_matches_jax(download, tmp_path, jax_scripts):
    jax_find = jax_scripts["reconstruction_generate_viable_heliostats_list"].find_viable_heliostats
    for minimum, excluded in ((SAMPLES, set()), (2, {"AC41"}), (1, set())):
        for maximum in (2200, 2):
            ours = reconstruction_generate_viable_heliostats_list.find_viable_heliostats(
                download, minimum, maximum, excluded, "flux"
            )
            assert ours == jax_find(download, minimum, maximum, excluded, "flux")
    names = [item["name"] for item in viable(download)]
    assert names == ["AA39", "AB40", "AC41"]  # AD42 lacks a HeliOS centroid, AC41's 999 an image
    assert all(len(item["calibrations"]) == SAMPLES for item in viable(download))
    path = reconstruction_generate_viable_heliostats_list.main(
        ["--data_dir", str(download), "--results_dir", str(tmp_path), "--minimum_number_of_measurements", "3"]
    )
    assert json.loads(path.read_text()) == viable(download)


def test_download_checks_say_what_is_missing(download, tmp_path):
    metadata = tmp_path / "metadata"
    assert download_metadata.validate(tmp_path, "table.csv")[0].startswith("missing the metadata table")
    metadata.mkdir()
    (metadata / "table.csv").write_text("HeliostatId,Other\n" + "".join(f"{name},1\n" for name in HELIOSTATS))
    assert download_metadata.validate(tmp_path, "table.csv") == []
    assert download_metadata.metadata_heliostats(metadata / "table.csv") == list(HELIOSTATS)
    assert download_data.validate(download, TOWER, list(HELIOSTATS), FOR_RAYTRACING) == []
    problems = download_data.validate(download, "tower.json", ["ZZ99"], {"AC41": 1})
    assert problems == [
        f"missing the tower measurements {download / 'tower.json'}", "missing heliostat properties for ZZ99",
        "missing calibration data for ZZ99", "missing the calibration 1 of AC41", "missing deflectometry for AC41",
    ]
    arguments = ["--metadata_root", str(tmp_path), "--metadata_file_name", "table.csv", "--data_dir", str(download),
                 "--tower_file_name", TOWER, "--heliostats_for_raytracing", "{}"]
    assert download_metadata.main(arguments[:4]) == 0
    assert download_data.main(arguments) == 0
    assert download_data.main(arguments[:4] + ["--data_dir", str(tmp_path)]) == 1
    assert "paint" not in sys.modules


# --------------------------------------------------------------------------- #
# The kinematics reconstruction.
# --------------------------------------------------------------------------- #


def jax_reconstruction_scenario(scripts, download: pathlib.Path, path: pathlib.Path) -> pathlib.Path:
    files = [(item["name"], pathlib.Path(item["properties"])) for item in viable(download)]
    scripts["reconstruction_scenario"].generate_reconstruction_scenario(path, download / TOWER, files)
    return path


def test_reconstruction_scenario_matches_jax(download, tmp_path, jax_scripts):
    theirs = jax_reconstruction_scenario(jax_scripts, download, tmp_path / "theirs.h5")
    files = reconstruction_scenario.heliostat_files(viable(download))
    ours = reconstruction_scenario.reconstruction_scenario_generator(
        tmp_path / "ours.h5", download / TOWER, files
    ).generate_scenario()
    assert_same_scenario_files(ours, theirs)
    in_memory = reconstruction_scenario.reconstruction_scenario(download / TOWER, files, device="cpu")
    from_file = load_scenario_from_hdf5(ours, reconstruction_scenario.SURFACE_POINTS, device="cpu")
    for a, b in zip(in_memory.heliostat_groups, from_file.heliostat_groups):
        torch.testing.assert_close(a.surface_points, b.surface_points, rtol=0, atol=0)
        assert a.names == b.names
    sun = from_file.light_sources[0]
    assert sun.number_of_rays == 10
    assert sun.distribution_parameters[constants.light_source_covariance] == pytest.approx(4.3681e-06)
    results = tmp_path / "results"
    reconstruction_generate_viable_heliostats_list.main(
        ["--data_dir", str(download), "--results_dir", str(results), "--minimum_number_of_measurements", "3"]
    )
    written = reconstruction_scenario.main(["--data_dir", str(download), "--tower_file_name", TOWER,
                                            "--results_dir", str(results), "--scenarios_dir", str(tmp_path / "s")])
    assert_same_scenario_files(written, theirs)


def port_factory(path: pathlib.Path):
    """Fresh port scenarios of ``path`` at 5 x 5 points, all drawing from one numpy stream
    (as the JAX runs draw from theirs)."""
    stream = DistortionStream(reconstruction_scenario.NUMBER_OF_RAYS)

    def scenario():
        loaded = load_scenario_from_hdf5(path, reconstruction_scenario.SURFACE_POINTS, device="cpu")
        loaded.light_sources[0] = stream
        return loaded

    return scenario


def pixel_width(scenario) -> float:
    """The width (m) of a pixel of the 256 x 256 maps on the calibration target."""
    tower = scenario.solar_tower
    return float(tower.planar_dimensions[tower.target_name_to_index[TARGET], 0]) / 256


def adam_bound(scenario, epochs: int) -> float:
    """How far apart two runs' focal spots can be after ``epochs`` Adam steps at
    :data:`RATE` each (about the rate a step, in either package, on each of a sample's
    four rotation deviations; a deviation turns the reflection by twice itself): at
    most 2 x epochs x 4 x 2 x rate x the longest heliostat-to-target distance (m)."""
    group, tower = scenario.heliostat_groups[0], scenario.solar_tower
    distance = float(torch.linalg.vector_norm(group.positions[:, :3] - tower.planar_centers[:, None, :3], dim=-1).max())
    return 2 * epochs * 4 * 2 * RATE * distance


def test_reconstruction_results_match_jax(download, tmp_path, monkeypatch, jax_scripts):
    jax_draws(monkeypatch)
    histories = {"theirs": [], "ours": []}
    jax_class = jax_scripts["reconstruction_generate_results"].KinematicsReconstructor

    class Recorded(jax_class):
        def reconstruct_kinematics(self, *args, **kwargs):
            final_loss, results = super().reconstruct_kinematics(*args, **kwargs)
            histories["theirs"].append(results[0].loss_history)
            return final_loss, results

    monkeypatch.setattr(jax_scripts["reconstruction_generate_results"], "KinematicsReconstructor", Recorded)
    path = jax_reconstruction_scenario(jax_scripts, download, tmp_path / "reconstruction.h5")
    mapping = reconstruction_generate_results.heliostat_data_mapping(viable(download))
    theirs = jax_scripts["reconstruction_generate_results"].generate_reconstruction_results(path, mapping, max_epoch=2)
    details = {}
    ours = reconstruction_generate_results.generate_reconstruction_results(
        port_factory(path), mapping, max_epoch=2, device="cpu", focal_spot_ground_truth="flux", details=details
    )
    histories["ours"] = [details[centroid]["results"][0].loss_history for centroid in ("UTIS", "HeliOS")]
    assert set(ours) == set(theirs) == {item["name"] for item in viable(download)}
    scenario = port_factory(path)()
    # Epoch 0, the mean over the heliostats, within SPOT_PIXELS; the last epoch's losses
    # within what Adam's steps can move a spot.
    for mine, other in zip(histories["ours"], histories["theirs"]):
        assert len(mine) == len(other) == 3
        np.testing.assert_allclose(mine[0], other[0], rtol=0, atol=SPOT_PIXELS * pixel_width(scenario))
    bound = adam_bound(scenario, 2)
    for name, entry in theirs.items():
        assert set(ours[name]) == set(entry) == {"UTIS", "HeliOS", "Position"}
        assert ours[name]["Position"] == entry["Position"]
        for key in ("UTIS", "HeliOS"):
            assert np.isfinite(ours[name][key])
            assert abs(ours[name][key] - entry[key]) <= bound, (name, key, ours[name][key], entry[key], bound)
    # The JAX script writes the cut into its module's configuration; the port builds its own.
    assert reconstruction_generate_results.OPTIMIZATION_CONFIGURATION[constants.optimization][
        constants.max_epoch] == 1000
    assert jax_scripts["reconstruction_generate_results"].OPTIMIZATION_CONFIGURATION[constants.optimization][
        constants.max_epoch] == 2


def test_reconstruction_holds_spots_to_the_measured_centroids(download, tmp_path):
    """The port's default ground truth, the parser's focal spots: the JAX script's where
    they are the measured flux's centre of mass; UTIS and HeliOS apart where their
    centroids are."""
    path = reconstruction_scenario.reconstruction_scenario_generator(
        tmp_path / "reconstruction.h5", download / TOWER, reconstruction_scenario.heliostat_files(viable(download))
    ).generate_scenario()
    mapping = reconstruction_generate_results.heliostat_data_mapping(viable(download))
    scenario = port_factory(path)()
    group, tower = scenario.heliostat_groups[0], scenario.solar_tower
    parsed = {
        centroid: reconstruction_generate_results.paint_parser(centroid).parse_data_for_reconstruction(
            mapping, group.names, tower.target_name_to_index, scenario.power_plant_position, (256, 256)
        )
        for centroid in reconstruction_generate_results.CENTROIDS
    }
    spread = np.linalg.norm(parsed["UTIS"].focal_spots - parsed["HeliOS"].focal_spots, axis=1)
    np.testing.assert_allclose(spread, HELIOS_OFFSET * np.sqrt(2), rtol=1e-2)
    flux = torch.as_tensor(parsed["UTIS"].flux_measured)
    targets = torch.as_tensor(parsed["UTIS"].target_area_indices, dtype=torch.long)
    centres = bitmap_coordinates_to_target_coordinates(get_center_of_mass(flux), (256, 256), tower, targets).numpy()
    at_centres = dict(vars(parsed["UTIS"]), focal_spots=centres)
    names = list(group.names)

    def results(ground_truth, parsers):
        return reconstruction_generate_results.generate_reconstruction_results(
            port_factory(path), max_epoch=0, device="cpu", focal_spot_ground_truth=ground_truth,
            data_parser=lambda centroid: parsers[centroid],
        )

    in_memory = {key: CalibrationDataParser(data, names) for key, data in parsed.items()}
    centred = {key: CalibrationDataParser(type(parsed["UTIS"])(**at_centres), names) for key in parsed}
    flux_truth, spot_truth, own = results("flux", centred), results("focal_spots", centred), results(
        "focal_spots", in_memory)
    for name in names:
        for key in ("UTIS", "HeliOS"):
            np.testing.assert_allclose(spot_truth[name][key], flux_truth[name][key], rtol=1e-5)
        assert abs(own[name]["UTIS"] - own[name]["HeliOS"]) > 1e-3
    with pytest.raises(ValueError, match="focal_spot_ground_truth"):
        results("centroid", in_memory)


# --------------------------------------------------------------------------- #
# The flux prediction.
# --------------------------------------------------------------------------- #


@pytest.fixture
def short_fits(monkeypatch, jax_scripts):
    """Both packages' fits cut to :data:`FIT_EPOCHS` epochs."""
    monkeypatch.setitem(flux_prediction_scenario.FIT, "nurbs_fit_max_epoch", FIT_EPOCHS)
    jax_module = jax_scripts["flux_prediction_scenario"]
    fitted = jax_module.extract_paint_heliostats_fitted_surface

    def cut(**kwargs):
        return fitted(**dict(kwargs, nurbs_fit_max_epoch=FIT_EPOCHS))

    monkeypatch.setattr(jax_module, "extract_paint_heliostats_fitted_surface", cut)
    return jax_module


def flux_scenarios(download: pathlib.Path, directory: pathlib.Path, jax_module) -> dict:
    """Both packages' ideal and fitted scenario files of :data:`FOR_RAYTRACING`."""
    directory.mkdir(parents=True, exist_ok=True)
    names = sorted(FOR_RAYTRACING)
    files = {}
    for stem, use in flux_prediction_scenario.SCENARIOS.items():
        theirs = directory / f"theirs_{stem}.h5"
        jax_module.generate_flux_prediction_scenario(theirs, download / TOWER, download, names, use)
        ours = flux_prediction_scenario.flux_prediction_scenario_generator(
            directory / f"ours_{stem}.h5", download / TOWER, download, names, use, device="cpu"
        ).generate_scenario()
        files[stem] = ours, theirs
    return files


def test_flux_prediction_scenarios_match_jax(download, tmp_path, short_fits):
    files = flux_scenarios(download, tmp_path, short_fits)
    assert_same_scenario_files(*files["ideal"])
    assert_same_scenario_files(*files["fitted"], FITTED_SURFACE_ATOL)
    for name in FOR_RAYTRACING:
        ours = flux_prediction_scenario.find_latest_deflectometry_file(name, download)
        assert ours == short_fits.find_latest_deflectometry_file(name, download)
    assert flux_prediction_scenario.find_latest_deflectometry_file("AA39", download).name.endswith("2023-06-01Z.h5")
    with pytest.raises(FileNotFoundError):
        flux_prediction_scenario.find_latest_deflectometry_file("AC41", download)
    # The fitted surfaces given in memory: the same scenario as the files' fits.
    names = sorted(FOR_RAYTRACING)
    generator = SurfaceGenerator(number_of_control_points=flux_prediction_scenario.CONTROL_POINTS)
    surfaces = {}
    for name in names:
        properties = flux_prediction_scenario.properties_path(download, name)
        translations, canting = extract_paint_heliostat_properties(properties, np.zeros(3))[1:3]
        points, normals = extract_paint_deflectometry_data(
            flux_prediction_scenario.find_latest_deflectometry_file(name, download), translations.shape[0]
        )
        surfaces[name] = generator.generate_fitted_surface_config(
            heliostat_name=name, facet_translation_vectors=translations, canting=canting,
            surface_points_with_facets_list=points, surface_normals_with_facets_list=normals,
            deflectometry_step_size=100, fit_method=constants.fit_nurbs_from_normals, tolerance=1e-10,
            max_epoch=FIT_EPOCHS, device="cpu",
        )
    given = flux_prediction_scenario.flux_prediction_scenario_generator(
        tmp_path / "given.h5", download / TOWER, download, names, True, fitted_surfaces=surfaces
    ).generate_scenario()
    assert_same_scenario_files(given, files["fitted"][0], FITTED_SURFACE_ATOL)
    # The command skips the fitted scenario where a heliostat has no deflectometry.
    written = flux_prediction_scenario.main(
        ["--config", str(write_config(tmp_path, download, {"AA39": 101, "AC41": 301})), "--device", "cpu"]
    )
    assert [p.name for p in written] == ["flux_prediction_ideal.h5"]


def write_config(directory: pathlib.Path, download: pathlib.Path, heliostats: dict) -> pathlib.Path:
    """A configuration file of the example with its paths under ``directory``."""
    config = yaml.safe_load(_config.CONFIG.read_text())
    config.update(
        data_dir=str(download), tower_file_name=TOWER, scenarios_dir=str(directory / "scenarios"),
        results_dir=str(directory / "results"), plots_dir=str(directory / "plots"),
        minimum_number_of_measurements=SAMPLES, heliostats_for_raytracing=heliostats,
    )
    path = directory / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    return path


def assert_flux_share(ours: np.ndarray, theirs: np.ndarray) -> float:
    """``test_torch_tutorials.assert_flux_close``: each map's sum within 1e-6 relative,
    each pixel within :data:`FLUX_SHARE` of the peak. Returns the largest gap's share."""
    assert np.isfinite(ours).all()
    assert_flux_close(torch.as_tensor(ours), theirs)
    return float(np.abs(ours - theirs).max() / np.max(theirs))


def test_flux_images_match_jax(download, tmp_path, monkeypatch, short_fits, jax_scripts):
    files = flux_scenarios(download, tmp_path, short_fits)
    jax_raytracing = jax_scripts["flux_prediction_raytracing"]
    monkeypatch.setattr(jax_raytracing, "NUMBER_OF_RAYS", PREDICTION_RAYS)
    monkeypatch.setattr(jax_raytracing, "load_scenario_from_hdf5", lambda path: jax_scenario_module.load_scenario_from_hdf5(
        path, number_of_surface_points_per_facet=PREDICTION_POINTS))
    jax_draws(monkeypatch)
    stream = DistortionStream(PREDICTION_RAYS)
    ours, theirs = {}, {}
    for stem, (mine, other) in files.items():
        jax_raytracing.generate_flux_images(other, FOR_RAYTRACING, download, theirs, stem)
        flux_prediction_raytracing.generate_flux_images(
            load_scenario_from_hdf5(mine, PREDICTION_POINTS, device="cpu"), FOR_RAYTRACING, download, ours, stem,
            sun=stream,
            device="cpu",
        )
    assert set(ours) == set(theirs) == {f"{name}/{key}" for name in FOR_RAYTRACING for key in ("ideal", "fitted", "utis")}
    for key, image in theirs.items():
        assert ours[key].shape == (256, 256)
        if key.endswith("utis"):
            np.testing.assert_array_equal(ours[key], image)
        else:
            assert_flux_share(ours[key], image)
    for name in FOR_RAYTRACING:
        assert np.abs(ours[f"{name}/ideal"] - ours[f"{name}/fitted"]).max() > 1e-3 * ours[f"{name}/ideal"].max()


def test_demo_prediction_matches_jax(tmp_path, monkeypatch):
    """The demo's calls (``flux_prediction_plot.py:143-177``) in both packages, at 20 x 20
    points a facet, the demo's 120 rays drawn from one numpy stream."""
    import jax.numpy as jnp
    from artist_tpu.field import heliostat_group as jax_hg
    from artist_tpu.flux.bitmap import crop_flux_distributions_around_center as jax_crop
    from artist_tpu.io.calibration import PaintCalibrationDataParser as JaxParser
    from artist_tpu.raytracing import RenderConfig as JaxRenderConfig
    from artist_tpu.raytracing import trace_rays as jax_trace_rays

    points = (20, 20)
    data_dir = write_paint_field(tmp_path / "field_data", heliostats=("AA39",))
    monkeypatch.setattr(flux_prediction_plot, "DEMO_SURFACE_POINTS", points)
    scenario = flux_prediction_plot.demo_scenario(data_dir, "AA39", device="cpu")
    mapping = flux_prediction_plot.demo_mapping(data_dir, "AA39")
    assert len(mapping[0][1]) == 3
    ours = flux_prediction_plot.demo_prediction(
        scenario, mapping, sun=DistortionStream(flux_prediction_plot.DEMO_RAYS), device="cpu"
    )

    power_plant, planar, cylindrical = jax_paint.extract_paint_tower_measurements(data_dir / "tower-measurements.json")
    heliostats, prototype = jax_paint.extract_paint_heliostats_ideal_surface(
        paths=[("AA39", data_dir / "AA39-heliostat-properties.json")],
        power_plant_position=power_plant.power_plant_position, number_of_nurbs_control_points=(7, 7),
    )
    path = tmp_path / "demo.h5"
    jax_h5_generator.H5ScenarioGenerator(
        file_path=path, power_plant_config=power_plant, target_area_list_planar_config=planar,
        target_area_list_cylindrical_config=cylindrical,
        light_source_list_config=jax_config.LightSourceListConfig(
            light_source_list=[jax_config.LightSourceConfig(light_source_key="sun_1", number_of_rays=120)]
        ),
        heliostat_list_config=heliostats, prototype_config=prototype,
    ).generate_scenario()
    jax_scenario = jax_scenario_module.load_scenario_from_hdf5(path, number_of_surface_points_per_facet=points)
    group, tower = jax_scenario.heliostat_groups[0], jax_scenario.solar_tower
    data = JaxParser().parse_data_for_reconstruction(
        heliostat_data_mapping=mapping, heliostat_names=group.names, target_name_to_index=tower.target_name_to_index,
        power_plant_position=jax_scenario.power_plant_position, bitmap_resolution=(256, 256),
    )
    active = jax_hg.gather_active(group, jax_hg.active_indices_from_mask(data.active_heliostats_mask))
    aligned, normals, _ = jax_hg.align_surfaces_with_motor_positions(active, jnp.asarray(data.motor_positions))
    distortions = DistortionStream(120).draw(aligned.shape[1], aligned.shape[0])
    flux, intercept, _, _ = jax_trace_rays(
        tower=tower, aligned_surface_points=aligned, aligned_surface_normals=normals,
        incident_ray_directions=jnp.asarray(data.incident_ray_directions),
        target_area_indices=jnp.asarray(data.target_area_indices),
        distortions_u=jnp.asarray(distortions[0]), distortions_e=jnp.asarray(distortions[1]),
        config=JaxRenderConfig(bitmap_resolution=(256, 256)),
    )
    predicted = np.asarray(jax_crop(flux, tower, jnp.asarray(data.target_area_indices)))
    assert_flux_share(ours["predicted"].numpy(), predicted)
    assert_flux_share(ours["flux"].numpy(), np.asarray(flux))
    np.testing.assert_allclose(ours["intercept"].numpy(), np.asarray(intercept), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours["measured"].numpy(), np.asarray(data.flux_measured))
    output = flux_prediction_plot.plot_demo(ours, "AA39", tmp_path / "plots" / "demo.png")
    assert output.stat().st_size > 0


# --------------------------------------------------------------------------- #
# The plots.
# --------------------------------------------------------------------------- #


class Recorder:
    """A stand-in for ``matplotlib.pyplot`` that records what is drawn on each axis."""

    def __init__(self):
        self.axes = []

    def subplots(self, rows=1, columns=1, **kwargs):
        grid = [[Axis(self) for _ in range(columns)] for _ in range(rows)]
        if kwargs.get("squeeze", True) and rows == columns == 1:
            return Figure(), grid[0][0]
        return Figure(), grid

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Figure:
    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Axis:
    def __init__(self, recorder):
        self.calls = []
        recorder.axes.append(self)

    def __getattr__(self, name):
        return lambda *args, **kwargs: self.calls.append((name, args, kwargs))

    def drawn(self, name):
        return [(args, kwargs) for call, args, kwargs in self.calls if call == name]


def synthetic_results(count: int = 150) -> dict:
    rng = np.random.RandomState(3)
    return {
        f"H{i:03d}": {"UTIS": float(rng.gamma(2.0, 0.3)), "HeliOS": float(rng.gamma(2.0, 0.5)),
                      "Position": [float(rng.uniform(-200, 200)), float(rng.uniform(30, 400)), 1.7, 1.0]}
        for i in range(count)
    }


def test_reconstruction_plot_data_match_jax(tmp_path, monkeypatch, jax_scripts):
    results = synthetic_results()
    jax_plot = jax_scripts["reconstruction_plot"]
    recorder = Recorder()
    monkeypatch.setattr(jax_plot, "plt", recorder)
    jax_plot.plot_error_distribution(results, tmp_path)
    jax_plot.plot_error_against_distance(results, 100, tmp_path, 7)
    distribution, distance = recorder.axes

    ours = reconstruction_plot.error_distribution_data(results)
    hists = distribution.drawn("hist")
    assert [kwargs["label"].split()[0] for _, kwargs in hists] == ours["order"]
    for (args, kwargs), key in zip(hists, ours["order"]):
        np.testing.assert_array_equal(args[0], ours["losses"][key])
        assert kwargs["range"] == (0, ours["x_max"]) and kwargs["bins"] == reconstruction_plot.BINS
    lines = distribution.drawn("plot")
    for (args, kwargs), key in zip(lines, ("HeliOS", "UTIS")):
        np.testing.assert_array_equal(args[0], ours["x_values"])
        np.testing.assert_allclose(args[1], ours["kde"][key], rtol=1e-12)
    means = [args[0] for args, _ in distribution.drawn("axvline")]
    assert means == pytest.approx([ours["means"]["HeliOS"], ours["means"]["UTIS"]], rel=1e-12)

    ours = reconstruction_plot.error_distance_data(results, 100, 7)
    assert ours["distances"].shape == (100,)
    for (args, _), key in zip(distance.drawn("scatter"), ("HeliOS", "UTIS")):
        np.testing.assert_array_equal(args[0], ours["distances"])
        np.testing.assert_array_equal(args[1], ours["losses"][key])
    for (args, _), key in zip(distance.drawn("plot"), ("HeliOS", "UTIS")):
        np.testing.assert_array_equal(args[0], ours["x_values"])
        np.testing.assert_allclose(args[1], ours["lines"][key], rtol=1e-12)

    json_path = tmp_path / "results" / reconstruction_generate_results.RESULTS_FILE
    json_path.parent.mkdir()
    json_path.write_text(json.dumps(results))
    written = reconstruction_plot.main(["--results_dir", str(json_path.parent), "--plots_dir", str(tmp_path / "p")])
    assert [p.name for p in written] == ["reconstruction_error_distribution.pdf", "reconstruction_error_distance.pdf"]
    assert all(p.read_bytes().startswith(b"%PDF") for p in written)


def test_flux_prediction_plot_data_match_jax(tmp_path, monkeypatch, jax_scripts):
    rng = np.random.RandomState(5)
    results = {f"{name}/{key}": rng.rand(8, 8).astype(np.float32) for name in ("AA39", "AY26")
               for key in ("utis", "ideal", "fitted")}
    del results["AY26/fitted"]
    results["AA39/ideal"][:] = 0.0
    path = tmp_path / "results.npz"
    np.savez(path, **results)
    jax_plot = jax_scripts["flux_prediction_plot"]
    recorder = Recorder()
    monkeypatch.setattr(jax_plot, "plt", recorder)
    jax_plot.plot_from_results(path, tmp_path / "theirs")
    names, grids = flux_prediction_plot.flux_grid_data(dict(np.load(path)))
    assert names == ["AA39", "AY26"]
    drawn = iter(axis.drawn("imshow") for axis in recorder.axes)
    for name in names:
        for key, _ in flux_prediction_plot.COLUMNS:
            calls = next(drawn)
            if grids[name, key] is None:
                assert not calls
            else:
                np.testing.assert_array_equal(calls[0][0][0], grids[name, key])
    output = flux_prediction_plot.main(["results", str(path), "--plots_dir", str(tmp_path / "ours")])
    assert output.name == "flux_prediction.pdf" and output.read_bytes().startswith(b"%PDF")


# --------------------------------------------------------------------------- #
# The commands, in the order of INSTRUCTIONS.md, on the CPU.
# --------------------------------------------------------------------------- #


def test_the_commands_run_the_example_on_the_cpu(download, tmp_path, monkeypatch, short_fits):
    config = ["--config", str(write_config(tmp_path, download, FOR_RAYTRACING))]
    monkeypatch.setattr(flux_prediction_raytracing, "NUMBER_OF_RAYS", 2)
    reconstruction_generate_viable_heliostats_list.main(config)
    reconstruction_scenario.main(config)
    path = reconstruction_generate_results.main(config + ["--max_epoch", "1", "--device", "cpu"])
    results = json.loads(path.read_text())
    assert set(results) == {"AA39", "AB40", "AC41"}
    assert all(np.isfinite(entry[key]) for entry in results.values() for key in ("UTIS", "HeliOS"))
    assert len(reconstruction_plot.main(config)) == 2
    assert len(flux_prediction_scenario.main(config + ["--device", "cpu"])) == 2
    npz = flux_prediction_raytracing.main(config + ["--device", "cpu"])
    with np.load(npz) as archive:
        assert set(archive.files) == {f"{n}/{k}" for n in FOR_RAYTRACING for k in ("ideal", "fitted", "utis")}
    assert flux_prediction_plot.main(["results", str(npz), "--plots_dir", str(tmp_path / "plots")]).exists()
    assert sorted(p.name for p in (tmp_path / "plots").iterdir()) == [
        "flux_prediction.pdf", "reconstruction_error_distance.pdf", "reconstruction_error_distribution.pdf"
    ]


# --------------------------------------------------------------------------- #
# chip_smoke.py's phase 18, at a small size on the CPU.
# --------------------------------------------------------------------------- #


def test_chip_smoke_phase_18_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 18 (``chip_smoke.drive_paint_reconstruction``, ``drive_paint_flux_prediction``,
    ``drive_paint_demo``) on the CPU: 6 heliostats in 2 rows of 3 and max_epoch 20 in 18a,
    small fits, points and rays in 18b and 18c. Its launch counts and kernel timings are
    the card's only."""
    cpu = torch.device("cpu")
    result, scenario, parser = chip_smoke.drive_paint_reconstruction(
        cpu, dict(chip_smoke.PAINT_FIELD, heliostats=6, row_spacing=12.0, columns=3, column_spacing=8.0), max_epoch=20
    )
    assert result["heliostats"] == 6 and result["samples"] == 18
    for centroid, run in result["runs"].items():
        assert run["epochs"] == 21 and not run["stopped"]
        # Each epoch a forward and a backward; validations at epochs 0 and 19 (max_epoch - 1).
        assert run["launches"] == chip_smoke.launches(splat_forward=23, splat_backward=21), centroid
    assert chip_smoke.paint_names(2601)[::1300] == ["AA00", "AN00", "BA00"]
    assert parser.parse_data_for_reconstruction(scenario.heliostat_groups[0].names).focal_spots.shape == (18, 4)

    size = dict(step=100, control_points=(6, 6), max_epoch=20)
    dents = chip_smoke.ingress_dents(3)
    surfaces = []
    for i, name in enumerate(chip_smoke.INGRESS_HELIOSTATS):
        path = tmp_path / f"{name}.binp"
        chip_smoke.write_ingress_stral(path, i, 3000, dents[i])
        cloud = chip_smoke.extract_stral_deflectometry_data(path)
        surfaces.append(chip_smoke.fit_stral_heliostat(cpu, name, cloud, size)["surface"])
    monkeypatch.setattr(chip_smoke, "PREDICTION_SURFACE_POINTS", (8, 8))
    monkeypatch.setattr(flux_prediction_raytracing, "NUMBER_OF_RAYS", 4)
    runs = chip_smoke.drive_paint_flux_prediction(cpu, surfaces)
    assert set(runs) == {"ideal", "fitted"}
    assert runs["ideal"]["run_to_run_spread"] == 0.0
    assert runs["fitted"]["rays"] == 3 * 4 * 4 * 64

    monkeypatch.setattr(flux_prediction_plot, "DEMO_SURFACE_POINTS", (10, 10))
    demo = chip_smoke.drive_paint_demo(cpu)
    assert demo["flux_gap_to_cpu"] == 0.0 and demo["samples"] == chip_smoke.TUTORIAL_SAMPLES

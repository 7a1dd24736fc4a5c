"""The port's field-optimization example (``artist_tpu_torch/examples/field_optimizations``)
against the JAX package's scripts (``examples/field_optimizations``), on one data directory.

The data are ``test_torch_tutorials``'s PAINT files: the tower, heliostats AA39 and
AB40 on a grid north of it, three calibration samples each. Both packages run on a
small configuration: the port's ``config.yaml`` with its paths in the test's
directory (one set for each package), 8 x 8 points a facet, 4 rays a point,
``max_epoch`` 2 in every stage and rates cut to 1e-7 (below). The JAX scripts
import each other by bare name, so the test puts their directory on ``sys.path``
and takes it and their modules off again. The JAX pipeline runs through its
``main`` (the configuration written as YAML); the port's through the same steps
with the scenario in memory, so that both packages draw the sun's distortions from
one numpy stream (``test_torch_tutorials.DistortionStream``), and once more
through its own ``main`` (the kinematics stage).

Held, with the tolerances the port's tests use for the same functions:

- the scenario files: both packages' loaders read both alike
  (``test_torch_tutorials.assert_same_scenario_files``);
- the metadata CSV and the viable lists: equal;
- each stage's ``.npz`` and ``.json``: the same names and keys; each stage's
  epoch-0 terms (kinematics 2e-3, surfaces 1e-3, aim points 1e-4 relative and
  their penalties as ``test_torch_tutorials.AIM_POINT_PENALTY``),
  the later epochs finite. They are not compared: the alignment loss turns the
  packages' ulp-level gap in its dots near 1 into 3e-3 of the loss by epoch 2
  (measured here; ``ROADMAP.md`` §3 calls it chaotic), and the other two part
  as ``test_torch_tutorials`` says. The factors 1e-4; the parameters within twice the
  steps Adam can take (3 epochs of the rate each, in either package). The
  stages chain, so each one's start carries the last one's gap: the rates are
  cut to 1e-7 so that the gap a stage hands on (at most 6e-7 rad or m) moves the
  next stage's epoch-0 loss far below its tolerance;
- the ``.binp`` files, parsed by both packages' ``io/stral.py`` readers: within
  1e-6 (the surfaces of both packages' control points, evaluated in fp32);
- the plots: the same files.
"""

import csv
import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from artist_tpu.io.stral import extract_stral_deflectometry_data as jax_extract_stral
from artist_tpu.util import logging_utils as jax_logging_utils
from artist_tpu_torch.examples.field_optimizations import (
    download_data,
    download_metadata,
    generate_plots,
    generate_results,
    generate_scenarios,
    generate_stral_inputs,
    generate_viable_heliostats_list,
)
from artist_tpu_torch.io.calibration import CalibrationDataParser
from artist_tpu_torch.io.stral import extract_stral_deflectometry_data
from artist_tpu_torch.parallel import setup_distributed_environment
from artist_tpu_torch.scenario.scenario import load_scenario_from_hdf5, load_scenario_from_image
from artist_tpu_torch.tools import ablate_step
from artist_tpu_torch.tutorials import (
    aim_point_optimization,
    field_raytracing_sharded,
    kinematics_reconstruction,
    single_heliostat_raytracing,
    surface_reconstruction,
)
from artist_tpu_torch.util import constants
from test_torch_tutorials import (
    DistortionStream,
    assert_same_scenario_files,
    jax_draws,
    write_calibration_samples,
    AIM_POINT_EPOCH_0,
    AIM_POINT_PENALTY,
    PLACES,
)
from test_torch_paint_parser import write_tower

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_EXAMPLE = REPO / "examples" / "field_optimizations"
JAX_MODULES = (
    "generate_scenarios", "download_data", "download_metadata", "generate_viable_heliostats_list",
    "generate_results", "generate_stral_inputs", "generate_plots",
)
HELIOSTATS = ("AA39", "AB40")
SAMPLES = 3
EPOCHS = 2
RATE = 1e-7
STAGES = ("kinematics", "surface", "aim_point")


def small_config(data: pathlib.Path, root: pathlib.Path) -> dict:
    config = generate_scenarios.load_config(None, data)
    for key in ("scenarios_dir", "results_dir", "plots_dir", "data_for_stral_dir"):
        config[key] = str(root / key)
    config["metadata_root"] = str(root)
    config["heliostats"] = list(HELIOSTATS)
    config["maximum_number_of_measurements"] = SAMPLES
    blocks = {stage: config[f"{stage}_{'optimization' if stage == 'aim_point' else 'reconstruction_optimization'}"
                            "_configuration"] for stage in STAGES}
    for block in blocks.values():
        block.update(max_epoch=EPOCHS, number_of_rays=4)
    blocks["surface"].update(number_of_surface_points=8, initial_learning_rate=RATE, lr_min=RATE / 10, lr_max=RATE)
    blocks["kinematics"].update(initial_learning_rate_rotation_deviation=RATE, lr_min=RATE / 10)
    blocks["aim_point"].update(initial_learning_rate=RATE, lr_min=RATE / 10)
    return config


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    directory = tmp_path_factory.mktemp("field_optimizations") / "data"
    directory.mkdir()
    write_tower(directory / "tower-measurements.json", 0)
    for i, name in enumerate(HELIOSTATS):
        chip_smoke.write_paint_heliostat(directory / f"{name}-heliostat-properties.json", *PLACES[i], 10 + i)
    for i, name in enumerate(HELIOSTATS):
        write_calibration_samples(directory, name, SAMPLES, 5 + i, 4)
    return directory


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


def run_jax_pipeline(monkeypatch, scripts: dict, config: dict, root: pathlib.Path) -> None:
    """The JAX pipeline's ``main`` on ``config`` (written as YAML), its sun drawing
    from the numpy stream."""
    root.mkdir(parents=True, exist_ok=True)
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    jax_draws(monkeypatch)
    monkeypatch.setattr(scripts["generate_results"], "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_logging_utils, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["generate_results.py", str(path)])
    scripts["generate_results"].main()


def run_port_pipeline(config: dict):
    """The port's pipeline as its ``main`` runs it, the scenario's sun a numpy stream:
    the scenario it leaves."""
    results_dir = pathlib.Path(config["results_dir"])
    scenario_path = generate_scenarios.generate_scenario(config)
    scenario = load_scenario_from_hdf5(scenario_path, number_of_surface_points_per_facet=(8, 8), device="cpu")
    scenario.light_sources[0] = DistortionStream(scenario.light_sources[0].number_of_rays)
    with setup_distributed_environment(len(scenario.heliostat_groups), device="cpu") as setup:
        outputs = generate_results.run_pipeline(scenario, config, results_dir, setup, device="cpu")
    assert list(outputs) == list(STAGES)
    return scenario


def _npz(path: pathlib.Path) -> dict:
    with np.load(path) as archive:
        return {key: archive[key] for key in archive.files}


def _json(path: pathlib.Path):
    return json.loads(path.read_text())


def test_metadata_viable_lists_and_validation_match_jax(data, tmp_path, jax_scripts):
    ours, theirs = small_config(data, tmp_path / "ours"), small_config(data, tmp_path / "theirs")
    assert download_data.validate(ours) == jax_scripts["download_data"].validate(theirs) == []
    missing = dict(ours, heliostats=["AA39", "ZZ99"])
    assert download_data.validate(missing) == jax_scripts["download_data"].validate(missing)
    assert len(download_data.validate(missing)) == 2
    paths = download_metadata.build_metadata(ours), jax_scripts["download_metadata"].build_metadata(theirs)
    rows = [list(csv.DictReader(open(path, newline=""))) for path in paths]
    assert rows[0] == rows[1] and len(rows[0]) == len(HELIOSTATS) * SAMPLES
    lists = generate_viable_heliostats_list.generate_lists(ours), jax_scripts[
        "generate_viable_heliostats_list"].generate_lists(theirs)
    for mine, other in zip(*lists):
        assert mine.name == other.name and _json(mine) == _json(other)
    assert [entry[0] for entry in _json(lists[0][0])] == list(HELIOSTATS)


def test_pipeline_matches_jax(data, tmp_path, monkeypatch, jax_scripts):
    ours, theirs = small_config(data, tmp_path / "ours"), small_config(data, tmp_path / "theirs")
    run_jax_pipeline(monkeypatch, jax_scripts, theirs, tmp_path / "theirs")
    scenario = run_port_pipeline(ours)
    ours_dir, theirs_dir = pathlib.Path(ours["results_dir"]), pathlib.Path(theirs["results_dir"])

    scenario_file = generate_scenarios.SCENARIO_FILE
    assert_same_scenario_files(pathlib.Path(ours["scenarios_dir"]) / scenario_file,
                               pathlib.Path(theirs["scenarios_dir"]) / scenario_file)
    names = sorted(p.name for p in theirs_dir.iterdir() if p.suffix in (".npz", ".json"))
    assert names == sorted(p.name for p in ours_dir.iterdir() if p.suffix in (".npz", ".json")) == [
        "aim_point_loss_history.json", "aim_point_optimization.npz", "kinematics_loss_history.json",
        "kinematics_reconstruction.npz", "surface_loss_history.json", "surface_reconstruction.npz",
    ]
    mine, other = ({name: (_npz if name.endswith(".npz") else _json)(d / name) for name in names}
                   for d in (ours_dir, theirs_dir))
    for name in names:
        assert set(mine[name]) == set(other[name]), name
    steps = 2 * (EPOCHS + 1) * RATE

    # Kinematics.
    for group, history in other["kinematics_loss_history.json"].items():
        ours_history = mine["kinematics_loss_history.json"][group]
        assert len(ours_history) == len(history) and np.isfinite(ours_history).all(), group
        np.testing.assert_allclose(ours_history[0], history[0], rtol=2e-3, err_msg=group)
    kinematics, jax_kinematics = mine["kinematics_reconstruction.npz"], other["kinematics_reconstruction.npz"]
    np.testing.assert_array_equal(np.isfinite(kinematics["final_loss"]), np.isfinite(jax_kinematics["final_loss"]))
    np.testing.assert_allclose(kinematics["group_0_rotation_deviations"],
                               jax_kinematics["group_0_rotation_deviations"], rtol=0, atol=steps)
    # The later stages read the deviations the kinematics stage left, and keep them.
    np.testing.assert_array_equal(scenario.heliostat_groups[0].rotation_deviations.numpy(),
                                  kinematics["group_0_rotation_deviations"])

    # Surfaces: epoch 0 of every term, the control points within Adam's steps.
    for group, terms in other["surface_loss_history.json"].items():
        for key, values in terms.items():
            rtol = 0 if key.startswith("flux_integral") else 1e-3
            atol = {"flux_integral": 1e-4, "flux_integral_constraint": 1e-5}.get(key, 1e-9)
            assert len(mine["surface_loss_history.json"][group][key]) == len(values), key
            np.testing.assert_allclose(mine["surface_loss_history.json"][group][key][0], values[0], rtol=rtol,
                                       atol=atol, err_msg=f"{group} {key}")
    surface, jax_surface = mine["surface_reconstruction.npz"], other["surface_reconstruction.npz"]
    np.testing.assert_array_equal(np.isfinite(surface["final_loss"]), np.isfinite(jax_surface["final_loss"]))
    np.testing.assert_allclose(surface["group_0_control_points"], jax_surface["group_0_control_points"], rtol=0,
                               atol=steps)

    # Aim points: epoch 0, the factors; nothing blocks (as test_torch_tutorials).
    aim, jax_aim = mine["aim_point_optimization.npz"], other["aim_point_optimization.npz"]
    np.testing.assert_array_equal(aim["blockings"], 1.0)
    np.testing.assert_array_equal(jax_aim["blockings"], 1.0)
    for key in ("intercepts", "on_targets"):
        np.testing.assert_allclose(aim[key], jax_aim[key], rtol=0, atol=1e-4, err_msg=key)
    for key, values in other["aim_point_loss_history.json"].items():
        history = mine["aim_point_loss_history.json"][key]
        assert len(history) == len(values) == EPOCHS + 1 and np.isfinite(history).all(), key
        np.testing.assert_allclose(history[0], values[0], **AIM_POINT_EPOCH_0.get(key, AIM_POINT_PENALTY), err_msg=key)
    # Each epoch moves a motor by at most the rate times its tanh scale (< 7e4 steps).
    np.testing.assert_allclose(aim["group_0_motor_positions"], jax_aim["group_0_motor_positions"], rtol=0,
                               atol=steps * 7e4)

    # The STRAL export of the reconstructed surfaces, read by both packages.
    written = generate_stral_inputs.generate_stral_inputs(ours, device="cpu")
    jax_written = jax_scripts["generate_stral_inputs"].generate_stral_inputs(theirs)
    assert [p.name for p in written] == [p.name for p in jax_written] == [f"{name}.binp" for name in HELIOSTATS]
    for path, jax_path in zip(written, jax_written):
        for reader in (extract_stral_deflectometry_data, jax_extract_stral):
            a, b = reader(path), reader(jax_path)
            for x, y in zip(a[:2], b[:2]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
            for x, y in zip(a[2] + a[3], b[2] + b[3]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)

    # The plots.
    plots = generate_plots.generate_plots(ours)
    monkeypatch.setattr(jax_scripts["generate_plots"], "load_config", lambda argv: theirs)
    jax_scripts["generate_plots"].main()
    assert sorted(p.name for p in plots) == sorted(p.name for p in pathlib.Path(theirs["plots_dir"]).iterdir()) == [
        "loss_histories.png"
    ]


def test_the_command_line_runs_a_stage_from_the_yaml(data, tmp_path, capsys):
    """``main`` of the port's pipeline on the CPU: the YAML file, the scenario file written
    where it is missing, one stage, its files."""
    config = small_config(data, tmp_path)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(dict(config, data_dir=None)))
    outputs = generate_results.main([str(path), "kinematics", "--data-dir", str(data), "--device", "cpu"])
    assert set(outputs) == {"kinematics"}
    assert (pathlib.Path(config["scenarios_dir"]) / generate_scenarios.SCENARIO_FILE).exists()
    results = pathlib.Path(config["results_dir"])
    assert set(_npz(results / "kinematics_reconstruction.npz")) == {"final_loss", "group_0_rotation_deviations"}
    assert "started: artist_tpu_torch.examples.field_optimizations.generate_results.kinematics_evaluation" in (
        results / "runtime_log.txt"
    ).read_text()
    assert "results written to" in capsys.readouterr().out


def test_stages_apply_their_sample_limit_and_rays(data):
    """The port applies each stage's ``sample_limit`` (a copy of the caller's parser
    limited) and ``number_of_rays`` (the scenario's sun for the stage)."""
    config = small_config(data, data.parent / "limits")
    block = dict(config["surface_reconstruction_optimization_configuration"], sample_limit=2, number_of_rays=3)
    scenario = load_scenario_from_image(
        generate_scenarios.scenario_generator(config, data.parent / "unused.h5").scenario_image(), (4, 4), device="cpu"
    )
    parser = generate_results._stage_data(block, config, None, None)[generate_results.constants.data_parser]
    calibration = CalibrationDataParser(
        parser.parse_data_for_reconstruction(
            heliostat_data_mapping=generate_results.build_heliostat_data_mapping(config), heliostat_names=HELIOSTATS,
            target_name_to_index=scenario.solar_tower.target_name_to_index,
            power_plant_position=scenario.power_plant_position, bitmap_resolution=(16, 16),
        ),
        HELIOSTATS,
    )
    np.testing.assert_array_equal(calibration.data.active_heliostats_mask, [2, 2])
    limited = generate_results._stage_data(block, config, calibration, [])[generate_results.constants.data_parser]
    assert limited is not calibration and calibration.sample_limit is None and limited.sample_limit == 2
    assert scenario.light_sources[0].number_of_rays == 4
    generate_results._stage_scenario(scenario, block, torch.device("cpu"))
    assert scenario.light_sources[0].number_of_rays == 3


def test_chip_smoke_pipeline_config_equals_config_yaml(tmp_path):
    """``chip_smoke.pipeline_config`` (the card's machine has no PyYAML) is the port's
    ``config.yaml`` but for its paths (and, where cut, phase 17b's epochs)."""
    paths = ("data_dir", "scenarios_dir", "results_dir", "plots_dir", "metadata_root", "data_for_stral_dir")
    yaml_config = generate_scenarios.load_config()
    mirror = chip_smoke.pipeline_config(tmp_path, cut=False)
    assert set(mirror) == set(yaml_config)
    assert {k: v for k, v in mirror.items() if k not in paths} == {
        k: v for k, v in yaml_config.items() if k not in paths
    }
    cut = chip_smoke.pipeline_config(tmp_path)
    for stage, epochs in chip_smoke.PIPELINE_EPOCHS.items():
        full = chip_smoke.stage_block(mirror, stage)["max_epoch"]
        assert chip_smoke.stage_block(cut, stage)["max_epoch"] == epochs < full


def test_chip_smoke_phase_17_runs_on_the_cpu(monkeypatch):
    """Phase 17 (``chip_smoke.drive_tutorials``, ``drive_pipeline``,
    ``drive_alignment_spread``, ``drive_tools``) at a small size on the CPU: the
    tutorials' widths and epochs, phase 13's field, the pipeline's epochs and the
    tools' field cut. Its launch counts are the card's only."""
    cpu = torch.device("cpu")
    for module, points in ((single_heliostat_raytracing, (10, 10)), (field_raytracing_sharded, (5, 5)),
                           (surface_reconstruction, (8, 8)), (kinematics_reconstruction, (5, 5)),
                           (aim_point_optimization, (5, 5))):
        monkeypatch.setattr(module, "SURFACE_POINTS", points)
    for module, epochs in ((surface_reconstruction, 3), (kinematics_reconstruction, 5), (aim_point_optimization, 3)):
        full = module.optimization_configuration

        def cut(full=full, epochs=epochs):
            configuration = full()
            configuration[constants.optimization][constants.max_epoch] = epochs
            return configuration

        monkeypatch.setattr(module, "optimization_configuration", cut)
    monkeypatch.setattr(chip_smoke, "TUTORIAL_RAYS", 8)
    runs = chip_smoke.drive_tutorials(cpu)
    assert set(runs) == {f"tutorial_0{i}" for i in range(1, 6)}
    assert runs["tutorial_01"]["flux_gap_to_cpu"] == 0.0
    assert runs["tutorial_04"]["distance_to_known"][1] < runs["tutorial_04"]["distance_to_known"][0]

    size = dict(heliostats=4, samples=4, surface_points=(5, 5), rays=3, bitmap=(256, 256))
    monkeypatch.setattr(chip_smoke, "KINEMATICS", size)
    monkeypatch.setattr(chip_smoke, "PIPELINE_EPOCHS", dict(surface=2, aim_point=2))
    known = chip_smoke.known_rotation_deviations(size["heliostats"])
    data = chip_smoke.kinematics_calibration(chip_smoke.kinematics_scenario(cpu, size), known, size["samples"],
                                             size["bitmap"])
    pipeline = chip_smoke.drive_pipeline(cpu, data, known)
    assert list(pipeline) == list(chip_smoke.PIPELINE_STAGES)
    assert pipeline["surface"]["epochs"] == 3 and pipeline["aim_point"]["epochs"] == 3
    spread = chip_smoke.drive_alignment_spread(cpu, data, known)
    assert set(spread["runs"]) == set(chip_smoke.SPREAD_RUNS)
    # One process on the CPU repeats itself bit for bit.
    assert spread["spread"]["final_loss_relative"] == 0 and spread["spread"]["deviations_largest"] == 0

    monkeypatch.setattr(chip_smoke, "MEMORY_REPORT", dict(heliostats=8, rays=2, surface_points=5, blocking=True))
    monkeypatch.setattr(chip_smoke, "MEMORY_REPORT_CHUNK", 4)
    small_ablate = ablate_step.ablate
    monkeypatch.setattr(ablate_step, "ablate", lambda device, block_window=None, steps=15: small_ablate(
        device, heliostats=4, surface_points=(10, 10), rays=4, ray_chunk=2, block_window=block_window and 32,
        steps=steps))
    tools = chip_smoke.drive_tools(cpu, dict(max_memory_allocated=None, unchunked_max_memory_allocated=None))
    assert set(tools) == {"memory_report_chunk_4", "memory_report_chunk_off", "ablate_step", "ablate_step_block_window"}
    assert tools["memory_report_chunk_4"]["saved_bytes"] < tools["memory_report_chunk_off"]["saved_bytes"]

"""The benchmark's layout: what it may import, a manifest that keeps the contract's limits, and a
configuration, a cell and a metric added as files alone."""

from __future__ import annotations

import ast
import json
import re

from benchmark import run

from conftest import REPO, TINY_SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "artist_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def imported_top_levels(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in (REPO / "benchmark").rglob("*.py"):
        assert not imported_top_levels(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (REPO / "benchmark" / "reference").rglob("*.py"):
        names = imported_top_levels(path)
        assert "artist_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "dataclasses", "torch", "benchmark"}, (path, names)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), (path, node.module)


def test_the_manifest_keeps_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1].startswith("benchmark/")
    cells = len(bench["workloads"])
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [entry["name"] for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"]
             + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(name) for name in names)
    for config in bench["configs"]:
        assert (REPO / config["file"]).is_file() and len(config["source"]) <= 200
    for cell in bench["workloads"]:
        workload = json.loads((REPO / "benchmark" / "workloads" / f"{cell['name']}.json").read_text())
        assert {k: workload[k] for k in ("config", "traffic", "chips", "why")} == {
            k: cell[k] for k in ("config", "traffic", "chips", "why")}
        assert len(cell["why"]) <= 200 and cell["chips"] == 1
    for metric in bench["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert any(metric["name"] == "setup_s" for metric in bench["end_to_end"])
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{metric['name']}.py").is_file(), metric["name"]
        assert set(metric.get("workloads", [])) <= {cell["name"] for cell in bench["workloads"]}
    assert all(metric["moves"] == "step_ms" for metric in bench["per_layer"])
    assert cells >= 1


def test_each_configuration_names_its_cuts():
    """The manifest's ``reduced`` of a configuration is the file's, and each key is a count of its field."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        assert sorted(config["reduced"]) == sorted(entry["reduced"]), entry["name"]
        assert all(isinstance(config["field"][key], int) for key in entry["reduced"]), entry["name"]
        assert config["source"] == entry["source"]


JOB = """from benchmark.jobs.surface_reconstruction import *  # noqa: F403
from benchmark.jobs.surface_reconstruction import LAUNCH_COUNTERS, build, kernel_work, make_traffic  # noqa: F401

SEEN = []


def make_traffic(arrays, parameters, seed, device):  # noqa: F811
    SEEN.append(seed)
    from benchmark import traffic

    return traffic.calibration(arrays, parameters, seed, device)
"""


def test_a_job_configuration_cell_and_metric_added_as_files_are_run(tiny_root):
    """A new job, configuration, cell and metric: new files and manifest entries, no edit."""
    (tiny_root / "benchmark" / "jobs" / "surface_noon.py").write_text(JOB)
    config = json.loads((tiny_root / "benchmark" / "configs" / "surface12.json").read_text())
    config["field"]["heliostats"] = 3
    config["job"] = "surface_noon"
    (tiny_root / "benchmark" / "configs" / "surface3.json").write_text(json.dumps(config))
    workload = json.loads((tiny_root / "benchmark" / "workloads" / "surface12.reconstruct.json").read_text())
    workload.update(config="surface3", traffic="bright_sun", why="a test cell")
    workload["traffic_parameters"]["calibration_hours_utc"] = [11.0, 12.0]
    (tiny_root / "benchmark" / "workloads" / "surface3.bright_sun.json").write_text(json.dumps(workload))
    (tiny_root / "benchmark" / "metrics" / "window.epochs.py").write_text(
        "def read(run):\n    return float(len(run.epoch_seconds)) or None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="surface3", file="benchmark/configs/surface3.json"))
    bench["workloads"].append(dict(name="surface3.bright_sun", config="surface3", traffic="bright_sun", chips=1,
                                   why="a test cell"))
    bench["end_to_end"].append(dict(name="window.epochs", unit="epochs", better="higher", bound=0.25,
                                    source="host_clock", workloads=["surface3.bright_sun"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell(tiny_root, "surface3.bright_sun", TINY_SEED, 0.5, False, run.torch.device("cpu"))
    assert result["correct"]
    assert result["metrics"]["window.epochs"]["value"] == result["attempted"]
    other = run.run_cell(tiny_root, "surface12.reconstruct", TINY_SEED, 0.2, False, run.torch.device("cpu"))
    assert "window.epochs" not in other["metrics"]


def test_a_run_loads_no_jax():
    """What a run imports (the harness, the jobs and the port) loads no JAX module, compared by whole top-level name."""
    import subprocess
    import sys

    code = ("import benchmark.run as run, benchmark.limits, benchmark.leaves, benchmark.jobs.surface_reconstruction, "
            "benchmark.jobs.kinematics_reconstruction; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

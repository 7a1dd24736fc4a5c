"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

They run on the CPU at a tiny size. Tests marked ``card`` need a CUDA card; the
``card`` fixture decides at run time and skips them here."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# Each configuration at a size a CPU test holds: widths kept, counts cut.
# The kinematics field keeps enough samples (1,000 train) that the alignment loss's mean
# is not one sample's: near a zero angle an fp32 ulp of a dot product moves its arccos far.
TINY_FIELD = {
    "surface12": dict(heliostats=2, surface_points=[5, 5], rays=4, bitmap=[32, 32]),
    "field100": dict(heliostats=50, surface_points=[5, 5], rays=4, bitmap=[32, 32]),
}
TINY_PROGRAM = {"surface12": {"ray_chunk": 2}}
TINY_BLOCK = {"surface12": 2, "field100": 250}
TINY_SEED = 2**31 + 5


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_copy(directory: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark's files under ``directory`` with every configuration cut
    to :data:`TINY_FIELD`, its blocks of samples to :data:`TINY_BLOCK`."""
    shutil.copytree(REPO / "benchmark", directory / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", directory / "BENCHMARK.json")
    for name, size in TINY_FIELD.items():
        path = directory / "benchmark" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config["field"].update(size)
        config["program"].update(TINY_PROGRAM.get(name, {}))
        path.write_text(json.dumps(config))
    for path in (directory / "benchmark" / "workloads").glob("*.json"):
        workload = json.loads(path.read_text())
        workload["traffic_parameters"]["cast_block"] = TINY_BLOCK[workload["config"]]
        workload["check"]["block"] = TINY_BLOCK[workload["config"]]
        path.write_text(json.dumps(workload))
    return directory


@pytest.fixture
def tiny_root(tmp_path) -> pathlib.Path:
    return tiny_copy(tmp_path)

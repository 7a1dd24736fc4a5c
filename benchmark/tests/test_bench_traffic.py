"""The traffic generator: the same seed gives the same calibration samples, another seed others."""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark import traffic
from benchmark.field import field_arrays

from conftest import TINY_SEED


def samples(root, cell: str, seed: int) -> dict:
    workload = json.loads((root / "benchmark" / "workloads" / f"{cell}.json").read_text())
    config = json.loads((root / "benchmark" / "configs" / f"{workload['config']}.json").read_text())
    return traffic.calibration(field_arrays(config["field"]), workload["traffic_parameters"], seed,
                               torch.device("cpu"))


def test_same_seed_same_samples(tiny_root):
    for cell in ("surface12.reconstruct", "field100.kinematics_alignment"):
        first, again = samples(tiny_root, cell, TINY_SEED), samples(tiny_root, cell, TINY_SEED)
        for key in first:
            np.testing.assert_array_equal(first[key], again[key], err_msg=f"{cell}: {key}")


def test_other_seed_other_samples_of_the_same_sizes(tiny_root):
    first, other = (samples(tiny_root, "field100.kinematics_raytracing", seed) for seed in (TINY_SEED, TINY_SEED + 1))
    for key in ("flux", "incident", "motors", "deviations"):
        assert first[key].shape == other[key].shape
        assert not np.array_equal(first[key], other[key]), key
    np.testing.assert_array_equal(first["counts"], other["counts"])


def test_flux_is_cast_onto_the_receiver(tiny_root):
    data = samples(tiny_root, "field100.kinematics_raytracing", TINY_SEED)
    assert np.all(data["flux"].sum(axis=(1, 2)) > 0)
    magnitudes = np.abs(data["deviations"]) * 1e3
    assert np.all((magnitudes >= 4.0) & (magnitudes <= 8.0))
    centred = samples(tiny_root, "surface12.reconstruct", TINY_SEED)
    assert np.all(centred["flux"].sum(axis=(1, 2)) > 0)
    assert not np.any(centred["deviations"])

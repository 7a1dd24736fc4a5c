"""The benchmark's aim-point job (cell ``aim1000.aim_point``) on the CPU at a tiny size.

The field is 8 heliostats of the cell's layout, two columns of its far corner (e of
-47.25 and -42.75 m, rows 165 to 180 m north), where the corridor test keeps a slot for
every heliostat behind the front row, more than four for some, and the fifth blocks rays
that the first four do not: 6 x 6
points a facet, 4 rays a point, 32 x 32 maps, chunks of 4 heliostats. The port runs
through the job's entry (``AimPointOptimizer.optimize``), the plain reference
(``benchmark/reference/aim_point.py``) follows the same 3 steps, and the check compares
them with the cell's own limits.
"""

from __future__ import annotations

import ast
import json
import math
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import artist_tpu_torch.raytracing.blocking as port_blocking
import artist_tpu_torch.raytracing.render as port_render
from benchmark import aim_point_leaves, check, limits, run
from benchmark import trace as tracing
from benchmark.field import field_arrays
from benchmark.jobs import aim_point_optimization as job

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "aim1000.aim_point"
SEED = 2**31 + 5
CORNER = dict(east=(-48.0, -42.0), north=165.0)  # the two columns and the first row kept
TINY = dict(surface_points=[6, 6], rays=4, bitmap=[32, 32])
CHUNK = 4


def cell_files() -> tuple[dict, dict]:
    _, _, workload, config = run.cell(REPO, CELL)
    return workload, config


def corner_field(config: dict) -> dict:
    """The cell's field cut to :data:`CORNER` at :data:`TINY` widths: its arrays."""
    positions = field_arrays(config["field"])["positions"]
    keep = ((positions[:, 0] >= CORNER["east"][0]) & (positions[:, 0] <= CORNER["east"][1])
            & (positions[:, 1] >= CORNER["north"]))
    config["field"].update(heliostats=int(keep.sum()), **TINY)
    arrays = field_arrays(config["field"])
    arrays["positions"] = np.ascontiguousarray(positions[keep])
    return arrays


def tiny(chunk: int = CHUNK, candidates: int | None = None):
    workload, config = cell_files()
    config["program"]["heliostat_chunk"] = chunk
    if candidates is not None:
        config["program"]["blocking_candidates"] = candidates
    return workload, config, corner_field(config)


def program_steps(chunk: int = CHUNK, candidates: int | None = None):
    workload, config, arrays = tiny(chunk, candidates)
    data = job.make_traffic(arrays, workload["traffic_parameters"], SEED, CPU)
    return run.first_steps(job.build(config, workload, arrays, data, SEED, CPU), int(workload["check"]["steps"]))


@pytest.fixture(scope="module")
def sides():
    """The port's first steps, the reference's, and the reference's inputs."""
    workload, config, arrays = tiny()
    data = job.make_traffic(arrays, workload["traffic_parameters"], SEED, CPU)
    steps, block = int(workload["check"]["steps"]), 2
    program = run.first_steps(job.build(config, workload, arrays, data, SEED, CPU), steps)
    inputs = job.reference_inputs(config, workload, arrays, data, SEED, CPU)
    reference = job.reference_steps(inputs, steps, block, CPU)
    limits_ = {key: float(value) for key, value in workload["check"]["limits"].items()}
    return dict(program=program, reference=reference, inputs=inputs, limits=limits_, steps=steps, block=block,
                workload=workload)


def test_the_corner_keeps_blocking_slots(sides):
    port_blocking.STATISTICS.clear()
    program_steps()
    counted = port_blocking.blocking_statistics()
    # Every heliostat but the front row's keeps a slot, and some keep more than four.
    assert counted["heliostats_kept"] == counted["heliostats"] * 7 // 8
    assert max(int(kept.sum(dim=1).max()) for _, kept in port_blocking.STATISTICS) > 4


def test_the_port_and_the_reference_agree_within_the_cells_limits(sides):
    numbers = check.compare(sides["program"], sides["reference"])
    assert check.verdict(numbers, sides["limits"]), numbers


def test_every_heliostat_agrees_with_the_reference(sides):
    """The worst leaf, not the median alone: on the CPU no fp32 noise of the card's
    summation order parts them, so a fault in a few heliostats (a chunk's edge, a far row)
    shows here."""
    numbers = check.compare(sides["program"], sides["reference"])
    assert numbers["loss_gap"] < 1e-5 and numbers["gradient_gap"] < 1e-3 and numbers["change_gap"] < 1e-3, numbers


def test_the_port_keeps_the_reference_candidates_in_every_chunk(sides):
    """Each heliostat's kept candidate blockers at the start, the port's first forward
    against the reference's corridor test, across the chunks' boundary."""
    workload, config, arrays = tiny()
    data = job.make_traffic(arrays, workload["traffic_parameters"], SEED, CPU)
    _, gradients, states, kept_port = aim_point_leaves.program_side(job, config, workload, arrays, data, SEED, CPU)
    kept_reference, largest, share, _ = aim_point_leaves.reference_look(sides["inputs"], sides["block"], CPU)
    assert kept_port == kept_reference and sum(map(len, kept_port.values())) > 8
    assert len(gradients) == len(states) == sides["steps"] and not states[0].any()
    torch.testing.assert_close(gradients[0], sides["program"].first_gradient[0].double())
    assert largest.shape == share.shape == (8,) and bool((largest > 0).all())


@pytest.mark.parametrize("fault", ["blocking_off", "candidates_4", "half_batch"])
def test_a_planted_reference_fault_fails_a_limit(sides, fault):
    faulty = limits.reference_readings(job, sides["inputs"], sides["steps"], sides["block"], CPU, fault=fault)
    numbers = check.compare(faulty, sides["reference"])
    assert not check.verdict(numbers, sides["limits"]), numbers


def test_the_port_without_blocking_fails_a_limit(sides, monkeypatch):
    # The compacted route on the cell's planar receiver reads sigma from render's blocking_sigma.
    monkeypatch.setattr(port_render, "blocking_sigma", lambda origins, directions, *args: torch.zeros(directions.shape[:2]))
    monkeypatch.setattr(port_render, "soft_ray_blocking_mask",
                        lambda ray_directions, **kwargs: torch.zeros(ray_directions.shape[:3]))
    numbers = check.compare(program_steps(), sides["reference"])
    assert not check.verdict(numbers, sides["limits"]), numbers


def test_the_port_with_four_candidates_fails_a_limit(sides):
    numbers = check.compare(program_steps(candidates=4), sides["reference"])
    assert not check.verdict(numbers, sides["limits"]), numbers


def test_chunked_and_unchunked_runs_give_the_same_loss_and_gradient(sides):
    chunked, whole = sides["program"], program_steps(chunk=0)
    np.testing.assert_allclose(chunked.losses, whole.losses, rtol=1e-6)
    torch.testing.assert_close(chunked.first_gradient, whole.first_gradient, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(chunked.end, whole.end, rtol=1e-5, atol=1e-9)


def test_the_reference_imports_nothing_of_either_package():
    for name in ("aim_point.py", "blocking.py"):
        tree = ast.parse((REPO / "benchmark" / "reference" / name).read_text())
        modules = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names}
        modules |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
        assert all(module == "__future__" or module.split(".")[0] in ("math", "torch", "benchmark")
                   for module in modules), (name, modules)
        assert all(module.startswith("benchmark.reference") for module in modules if module.startswith("benchmark"))
    code = ("import sys, benchmark.reference.aim_point; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'artist_tpu', 'artist_tpu_torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_blocking_counter_reads_nothing_from_the_device():
    """The compacted route keeps its kept-slot mask as computed: no scalar read, no copy."""
    generator = torch.Generator().manual_seed(3)
    heliostats, rays, points, primitives = 3, 2, 16, 5
    origins = torch.randn((heliostats, points, 4), generator=generator)
    directions = torch.nn.functional.normalize(torch.randn((heliostats, rays, points, 4), generator=generator), dim=-1)
    corners = torch.randn((primitives, 4, 4), generator=generator) * 3
    spans = torch.stack([corners[:, 1] - corners[:, 0], corners[:, 3] - corners[:, 0]], dim=1)
    normals = torch.nn.functional.normalize(torch.randn((primitives, 4), generator=generator), dim=-1)
    distances = torch.rand((heliostats, rays, points), generator=generator) * 50
    port_blocking.STATISTICS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as profiler:
        port_blocking.soft_ray_blocking_mask(origins, directions, corners, spans, normals, distances,
                                             torch.arange(heliostats), max_candidates=16)
    names = {event.name() for event in profiler.profiler.kineto_results.events()}
    assert not names & {"aten::_local_scalar_dense", "aten::item"}, names
    ((counted_rays, kept),) = port_blocking.STATISTICS
    assert counted_rays == heliostats * rays * points
    assert kept.dtype == torch.bool and kept.shape == (heliostats, primitives)
    counted = port_blocking.blocking_statistics()
    assert counted == dict(forwards=1, rays=heliostats * rays * points, heliostats=heliostats,
                           candidate_slots=heliostats * primitives, kept_slots=int(kept.sum()),
                           heliostats_kept=int(kept.any(dim=1).sum()))


def test_the_sigma_launches_and_their_bound(sides):
    chunks = job.aim_point.chunk_work(sides["inputs"], CHUNK, sides["block"], CPU)
    sigma, splat = [chunk["sigma"] for chunk in chunks], [chunk["splat"] for chunk in chunks]
    assert len(chunks) == 2 and sum(chunk["heliostats"] for chunk in sigma) == 8
    assert all(0 < chunk["zero"] <= chunk["zero_or_dark"] <= chunk["kept_pairs"] for chunk in sigma)
    rays = 4 * 4 * 36 * 4  # heliostats x rays x points
    assert [chunk["maps"] for chunk in splat] == [4, 4] and all(chunk["rays"] == rays for chunk in splat)
    assert all(0 < chunk["valid"] <= chunk["rays"] and 0 < chunk["touched"] <= 4 * 32 * 32 for chunk in splat)
    calls = [{"epochs": 3, "stopped": False}]
    work = job.kernel_work(sides["inputs"], sides["block"], calls, {}, CPU)
    for family in ("sigma", "splat"):
        kinds = [kind for kind, _ in work[family]]
        assert kinds.count("forward") == 2 + 3 * 2 * 2 and kinds.count("backward") == 3 * 2
    whole = job.kernel_work(dict(sides["inputs"], options=dict(sides["inputs"]["options"], chunk=8)),
                            sides["block"], calls, {}, CPU)
    assert len(whole["sigma"]) == len(whole["splat"]) == 1 + 3 * 2  # unchunked: no recompute


def test_the_blocking_roofline_reader():
    from benchmark.blocking_work import sigma_bound_ms

    reader = run.reader(REPO, "kernels.blocking_roofline")
    work = dict(heliostats=250, rays=300000, points=10000, slots=16, needed=249, kept_slots=1000,
                kept_pairs=300_000_000, zero=200_000_000, zero_or_dark=210_000_000)
    trace = tracing.Trace(device=[("sigma_forward_kernel", 0.0, 2e-3, "kernel"),
                                  ("sigma_backward_kernel", 2e-3, 6e-3, "kernel"),
                                  ("sigma_flat_forward_kernel", 6e-3, 7e-3, "kernel")],
                          runtime=[], host=[], start=0.0, end=1e-2, epochs=1,
                          counters={"artist_tpu_torch.kernels.blocking": {"blocking_sigma_forward": 1,
                                                                           "blocking_sigma_backward": 1}},
                          work={"sigma": [("forward", work), ("backward", work)]})
    expected = 100.0 * (sigma_bound_ms("forward", work) + sigma_bound_ms("backward", work)) * 1e-3 / 6e-3
    assert math.isclose(reader.read(run.Run(trace=trace)), expected)
    # 72 operations a live pair, 60 a zero one; bytes as the pair's kernels read and write them.
    assert sigma_bound_ms("forward", work) == pytest.approx(
        max((72 * 1e8 + 60 * 2e8) / 67e12, (4 * 250 * 3e5 + 4 * 250 * 16 + 249 * (20 * 3e5 + 16e4) + 64e3) / 3.35e12)
        * 1e3)
    trace.counters["artist_tpu_torch.kernels.blocking"]["blocking_sigma_backward"] = 2
    with pytest.raises(RuntimeError):
        reader.read(run.Run(trace=trace))


def test_the_kept_slot_share_reader():
    reader = run.reader(REPO, "blocking.kept_slot_share")
    trace = tracing.Trace(device=[], runtime=[], host=[], start=0.0, end=1.0, epochs=1)
    port_blocking.STATISTICS.clear()
    assert reader.read(run.Run(trace=trace)) is None
    port_blocking.STATISTICS.extend([(10, torch.tensor([[True, False], [False, False]])),
                                     (10, torch.tensor([[True, True], [False, True]]))])
    assert reader.read(run.Run(trace=trace)) == pytest.approx(100.0 * 4 / 8)
    assert reader.read(run.Run()) is None
    port_blocking.STATISTICS.clear()


def test_the_cell_runs_through_the_harness(tmp_path):
    """The cell through ``run_cell``, untraced and traced, at the tiny size."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    config_path = tmp_path / "benchmark" / "configs" / "aim1000.json"
    config = json.loads(config_path.read_text())
    config["field"].update(heliostats=8, layout=dict(config["field"]["layout"], first_row_n=165.0), **TINY)
    config["program"]["heliostat_chunk"] = CHUNK
    config["optimization"]["max_epoch"] = 3  # a traced call of 4 epochs
    config_path.write_text(json.dumps(config))
    workload_path = tmp_path / "benchmark" / "workloads" / f"{CELL}.json"
    workload = json.loads(workload_path.read_text())
    workload["check"]["block"] = 2
    workload_path.write_text(json.dumps(workload))
    untraced = run.run_cell(tmp_path, CELL, SEED, 0.5, False, CPU)
    assert untraced["attempted"] >= 1 and {"step_ms", "setup_s"} <= set(untraced["metrics"])
    traced = run.run_cell(tmp_path, CELL, SEED, 0.5, True, CPU)
    assert traced["window"] == {"calls": 1, "epochs": 4}
    assert untraced["correct"] and traced["correct"], (untraced["checked"], traced["checked"])

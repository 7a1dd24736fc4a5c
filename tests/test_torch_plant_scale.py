"""Plant scale on the CPU: the chunked flagship step against ``bench.py``'s, the launch
counts ``chip_smoke.py`` phase 14 asserts, what a checkpointed chunk keeps, the
plant-scale example, and a rehearsal of phase 14 at a small size.

Tolerances: the chunked step against the JAX package's chunked step is held as
``tests/test_torch_render.py`` holds the unchunked one (loss rtol 1e-4, gradient
1e-3 of its largest entry, under a ground truth of ones on the spot), and against
the port's own unchunked step to the JAX package's bound for its own pair
(``tests/parallel/test_microbatch.py``: loss 1e-4 relative, gradient 1e-5 of the
largest entry). Launch counts are counted exactly, as calls of the kernels' plain
versions, which the CPU runs in their place.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import chip_smoke
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.kernels import blocking as blocking_kernels
from artist_tpu_torch.kernels import lbvh as lbvh_kernels

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SPLAT = sys.modules["artist_tpu_torch.kernels.splat"]
# Each kernel of chip_smoke.KERNELS that the plant paths launch, by its plain version.
PLAIN = {
    "splat_forward": (SPLAT, "splat_forward_plain"),
    "splat_backward": (SPLAT, "splat_backward_plain"),
    "blocking_sigma_forward": (blocking_kernels, "sigma_forward_plain"),
    "blocking_sigma_backward": (blocking_kernels, "sigma_backward_plain"),
    "blocking_cull": (blocking_kernels, "cull_plain"),
    "blocking_sigma_flat_forward": (blocking_kernels, "sigma_flat_forward_plain"),
    "blocking_sigma_flat_backward": (blocking_kernels, "sigma_flat_backward_plain"),
    "lbvh_traverse": (lbvh_kernels, "traverse_plain"),
}


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions' calls, by kernel name, for every kernel of the table."""
    calls = dict.fromkeys(chip_smoke.KERNELS, 0)
    for name, (module, attribute) in PLAIN.items():
        original = getattr(module, attribute)

        def counted(*args, _name=name, _original=original, **kwargs):
            calls[_name] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, attribute, counted)
    return calls


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


@pytest.mark.parametrize("chunk", [None, 2], ids=["unchunked", "chunk2"])
@pytest.mark.parametrize("candidates", [16, None], ids=["compacted", "flat"])
def test_plant_aim_point_launches(plain_calls, candidates, chunk):
    """An optimize() call of 2 epochs on 4 heliostats: the kernels' calls equal
    chip_smoke.plant_aim_point_launches (the recompute reruns each chunk's forwards)."""
    scenario = chip_smoke.aim_point_scenario(CPU, 4, (3, 3), 2, row_spacing=chip_smoke.DENSE_ROW_SPACING)
    optimizer = chip_smoke.aim_point_optimizer(
        scenario, chip_smoke.aim_point_ground_truth((32, 32), CPU), 1, candidates, (32, 32), heliostat_chunk=chunk
    )
    optimizer.optimize("kl_divergence")
    assert plain_calls == chip_smoke.plant_aim_point_launches(2, 2 if chunk else 1, candidates)


@pytest.mark.parametrize("chunk", [None, 2], ids=["unchunked", "chunk2"])
@pytest.mark.parametrize(("blocking", "candidates"), [(False, 16), (True, 16), (True, None)],
                         ids=["plain", "compacted", "flat"])
def test_xl_step_launches(plain_calls, blocking, candidates, chunk):
    """One step of the flagship step with 2 rays a point in ray chunks of 1 on 4
    heliostats: the kernels' calls equal chip_smoke.xl_step_launches (the nested
    checkpoints run each ray chunk's splat forward three times, its sigma forward twice)."""
    size = dict(heliostats=4, rays=2, ray_chunk=1, surface_points=(3, 3), bitmap=(32, 32))
    inputs = chip_smoke.xl_inputs(CPU, blocking, candidates, chunk, size)
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    chip_smoke.surface_loss(control_points, inputs).backward()
    assert plain_calls == chip_smoke.xl_step_launches(2 if chunk else 1, 2, candidates, blocking)


def _saved(loss_fn) -> list[tuple]:
    """Shapes of the tensors autograd keeps for the backward of ``loss_fn()``, outside any
    checkpoint (a checkpoint's own hooks take those saved inside it)."""
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = loss_fn()
    loss.backward()
    return saved


def _xl_loss(heliostats: int, chunk: int | None):
    size = dict(heliostats=heliostats, rays=2, ray_chunk=1, surface_points=(5, 5), bitmap=(32, 32))
    inputs = chip_smoke.xl_inputs(CPU, True, 16, chunk, size)
    control_points = inputs.scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    return lambda: chip_smoke.surface_loss(control_points, inputs)


def _aim_point_loss(heliostats: int, chunk: int | None):
    scenario = chip_smoke.aim_point_scenario(CPU, heliostats, (5, 5), 2, row_spacing=chip_smoke.DENSE_ROW_SPACING)
    optimizer = chip_smoke.aim_point_optimizer(
        scenario, chip_smoke.aim_point_ground_truth((32, 32), CPU), 0, 16, (32, 32), heliostat_chunk=chunk
    )
    params, forward, loss_fn = optimizer.objective("kl_divergence")
    with torch.no_grad():
        flux, intercepts, _, _ = forward(params)
    for param in params:
        param.requires_grad_(True)
    references, lambdas = (flux.sum(), intercepts), (torch.zeros(()),) * 3
    return lambda: loss_fn(params, references, lambdas)[0]


@pytest.mark.parametrize("loss", [_xl_loss, _aim_point_loss], ids=["xl_step", "aim_point"])
def test_a_chunk_keeps_no_aligned_surface(loss):
    """Gathering, NURBS (the step), alignment and the trace run inside each chunk's
    checkpoint: with chunks of 2, what autograd keeps outside them has no tensor of the
    100 surface points, and grows by a few floats a heliostat from 8 to 16 heliostats;
    unchunked it keeps every heliostat's points and rays."""
    points = 100
    sizes = {}
    for chunk in (None, 2):
        for heliostats in (8, 16):
            shapes = _saved(loss(heliostats, chunk))
            sizes[chunk, heliostats] = sum(4 * int(np.prod(shape)) for shape in shapes)
            if chunk:
                assert not any(points in shape for shape in shapes), shapes
    growth = {chunk: (sizes[chunk, 16] - sizes[chunk, 8]) / 8 for chunk in (None, 2)}
    assert growth[None] > 4 * 4 * points  # more than a heliostat's aligned points a heliostat
    assert growth[2] <= 64


@pytest.fixture(scope="module")
def small_bench(request):
    """bench.py's flagship step at a small size (4 heliostats, 5 x 5 points a facet, 32 x 32,
    2 rays a point in ray chunks of 1), with the same wide numpy distortions in both packages."""
    patch = pytest.MonkeyPatch()
    patch.setattr(bench, "SURFACE_POINTS", (5, 5))
    patch.setattr(bench, "BITMAP", (32, 32))
    request.addfinalizer(patch.undo)
    jax_scenario = jax_synthetic(number_of_heliostats=4, number_of_surface_points_per_facet=(5, 5), number_of_rays=2)
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position, _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources], [_as_dict(g) for g in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names, device="cpu",
    )
    rng = np.random.RandomState(11)
    du, de = rng.normal(0.0, 1e-2, (2, 4, 2, 100)).astype(np.float32)
    inputs = chip_smoke.step_inputs(scenario, torch.tensor(du), torch.tensor(de), (5, 5), (32, 32), 1,
                                    blocking=True, candidates=2)
    with torch.no_grad():
        flux = chip_smoke.render(scenario.heliostat_groups[0].nurbs_control_points, inputs)[0].numpy()
    spot = (flux > 0.05 * flux.max(axis=(1, 2), keepdims=True)).astype(np.float32)
    return scenario, du, de, spot


@pytest.mark.parametrize("blocking", [True, False], ids=["blocking", "plain"])
def test_chunked_flagship_step_matches_bench(small_bench, blocking):
    """``heliostat_chunk=2`` of 4 heliostats: the port's chunked step against
    ``bench._build_step(..., heliostat_chunk=2)``, and against its own unchunked step."""
    scenario, du, de, spot = small_bench
    step, args, _ = bench._build_step(blocking=blocking, heliostats=4, rays=2, ray_chunk=1, candidates=2,
                                      heliostat_chunk=2)
    loss_jax, grad_jax = step(args[0], args[1], jnp.asarray(du), jnp.asarray(de), jnp.asarray(spot))
    grad_jax = np.asarray(grad_jax)
    results = {}
    for chunk in (None, 2):
        inputs = chip_smoke.step_inputs(scenario, torch.tensor(du), torch.tensor(de), (5, 5), (32, 32), 1,
                                        blocking=blocking, candidates=2, heliostat_chunk=chunk)
        inputs = dataclasses.replace(inputs, ground_truth=torch.tensor(spot))
        control_points = scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
        loss = chip_smoke.surface_loss(control_points, inputs)
        loss.backward()
        results[chunk] = (loss.item(), control_points.grad.numpy())
    loss, grad = results[2]
    np.testing.assert_allclose(loss, float(loss_jax), rtol=1e-4)
    assert np.abs(grad_jax).max() > 0
    np.testing.assert_allclose(grad, grad_jax, rtol=0, atol=1e-3 * np.abs(grad_jax).max())
    np.testing.assert_allclose(loss, results[None][0], rtol=1e-4)
    np.testing.assert_allclose(grad, results[None][1], rtol=0, atol=1e-5 * np.abs(results[None][1]).max())


def test_plant_scale_example_runs_on_the_cpu():
    """``python -m artist_tpu_torch.examples.plant_scale_aim_points --device cpu`` at a small
    size: its line, with a history of PLANT_EPOCHS + 1 finite losses."""
    env = dict(os.environ, PLANT_HELIOSTATS="16", PLANT_CHUNK="8", PLANT_SURFACE_POINTS="3", PLANT_EPOCHS="2")
    done = subprocess.run(
        [sys.executable, "-m", "artist_tpu_torch.examples.plant_scale_aim_points", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr
    line = done.stdout.strip().splitlines()[-1]
    assert line.startswith("16 heliostats, chunk 8: final loss ")
    history = eval(line.split("history ", 1)[1].split("], ", 1)[0] + "]")  # noqa: S307 - the example's own list
    assert len(history) == 3 and np.isfinite([float(x) for x in history]).all()


def test_chip_smoke_phase_14_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 14's functions end to end with the CPU in the card's place, at a
    small size: the CUDA wrappers replaced by their plain versions and the card's timers by
    stand-ins. The launch-count gates are the card's; the CPU launches nothing."""
    monkeypatch.setattr(chip_smoke, "event_ms", lambda fn, iterations=20, warmup=3: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, iterations=20: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(lbvh_kernels, "traverse_cuda", lambda *args: lbvh_kernels.traverse_plain(*args))
    for name in ("cull", "sigma_forward", "sigma_backward"):
        monkeypatch.setattr(blocking_kernels, f"{name}_cuda", getattr(blocking_kernels, f"{name}_plain"))
    monkeypatch.setattr(chip_smoke, "splat_forward_cuda", chip_smoke.splat_forward_plain)
    monkeypatch.setattr(chip_smoke, "splat_backward_cuda", chip_smoke.splat_backward_plain)

    aim = chip_smoke.drive_plant_aim_point(CPU, dict(heliostats=16, chunk=8, points=3))
    assert aim["epochs"] == (2, 11) and len(aim["losses"]) == 11
    assert all(gap <= 1e-4 for gap in aim["unchunked_gaps"].values())
    xl = chip_smoke.drive_xl_step(CPU, dict(heliostats=8, rays=2, ray_chunk=1, heliostat_chunk=4,
                                            surface_points=(3, 3), bitmap=(32, 32)))
    assert set(xl) == {"plain", "k16", "k8", "k32", "comparison"}
    size = dict(heliostats=64, chunk=16, surface_points=(3, 3), rays=2)
    timings, path = chip_smoke.check_lbvh(CPU, **size)
    dense = timings["lbvh_traverse"]["dense_rows"]
    assert dense["kept"] > 0 and dense["visits"] > 0
    kernels = chip_smoke.check_plant_kernels(CPU, **size)
    assert set(kernels) == {"splat_forward", "splat_backward", "blocking_sigma_forward", "blocking_sigma_backward"}
    assert kernels["blocking_sigma_backward"]["plant_chunk_k32"]["shape"] == [16, 72, 32]
    assert kernels["splat_forward"]["plant_chunk"]["shape"] == [16, 72]

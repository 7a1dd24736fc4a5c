"""The compacted blocking route's kernels (``artist_tpu_torch/kernels/blocked_rays.py``) on the CPU.

Their plain versions, through ``render.blocked_splat_inputs``, are held to the PyTorch chain
they replace (``render.ray_splat_inputs`` with ``soft_ray_blocking_mask``'s compacted route and
``trace_rays``' counts), the hand-derived backwards to autograd through that chain and to
``gradcheck`` in float64, the kept candidates to ``select_blocking_candidates`` on the
aim1000.aim_point cell's corner field, and ``trace_rays`` to its choice of route.
``chip_smoke.py`` phase 20 holds the CUDA kernels to these plain versions on the card, on the
same grid field (``chip_smoke.blocked_chunk_inputs``) and on the cell's first chunk.

Tolerances: the plain forwards compute the chain's products and sums in the chain's order,
so they equal it bit for bit; the backwards sum their terms in another order than autograd,
so they agree to fp32 round-off of the largest gradient entry.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from artist_tpu_torch.kernels import blocked_rays, rays
from artist_tpu_torch.raytracing import blocking, render
from benchmark import run as benchmark_run
from benchmark.field import field_arrays
from benchmark.jobs import aim_point_optimization as aim_point_job

CPU = torch.device("cpu")
BITMAP = (64, 48)
EXTINCTION = 0.1
K = 16
# ray_edge_cases on the receiver: valid or not, in their order (tests/test_torch_ray_kernel.py).
EDGE_VALID = [True, False, True, False, True, False, True, False, True, False, False, True, True]
MAGNITUDES = ["float", "scalar tensor", "per heliostat"]
PLAIN = ("trace_forward_plain", "corridor_statistics_plain", "epilogue_plain", "epilogue_backward_plain",
         "trace_backward_plain")


def _inputs(dtype=torch.float32, **size):
    size = {**chip_smoke.BLOCKED_GRID, **size}
    inputs = chip_smoke.blocked_chunk_inputs(size["heliostats"], size["rays"], size["points"], CPU, 5, dtype)
    return dict(inputs, bitmap=BITMAP, extinction=EXTINCTION)


def _magnitude(inputs, kind):
    return {"float": 1.7, "scalar tensor": torch.tensor(1.7), "per heliostat": inputs["magnitudes"]}[kind]


def _config(inputs, **options):
    return render.RenderConfig(bitmap_resolution=inputs["bitmap"], ray_extinction_factor=EXTINCTION,
                               blocking_active=True, blocking_candidates=K, **options)


def _route(inputs, magnitude, preferred=None, origins=None, primitives=None):
    """``blocked_splat_inputs``: e, u, w and the rays on target, intercepted and unblocked."""
    return render.blocked_splat_inputs(
        inputs["tower"], inputs["preferred"] if preferred is None else preferred,
        inputs["origins"] if origins is None else origins, inputs["targets"], inputs["distortions_u"],
        inputs["distortions_e"], magnitude, _config(inputs), inputs["primitives"] if primitives is None else primitives,
        inputs["own"],
    )


def _chain(inputs, magnitude, preferred=None, origins=None, primitives=None):
    """The PyTorch chain with the compacted route's mask: e, u, w and trace_rays' counts."""
    chain = render.ray_splat_inputs(
        inputs["tower"], inputs["preferred"] if preferred is None else preferred,
        inputs["origins"] if origins is None else origins, inputs["targets"], inputs["distortions_u"],
        inputs["distortions_e"], magnitude, _config(inputs), inputs["primitives"] if primitives is None else primitives,
        inputs["own"],
    )
    return (chain.bitmap_e, chain.bitmap_u, chain.final_intensities, torch.sum(chain.intensities > 0, dim=(1, 2)),
            torch.sum(chain.final_intensities > 0, dim=(1, 2)), torch.sum(chain.blocked < 1e-3, dim=(1, 2)))


def _leaves(inputs):
    """Copies of the preferred directions, origins and primitives that require a gradient."""
    return (inputs["preferred"].clone().requires_grad_(True), inputs["origins"].clone().requires_grad_(True),
            tuple(x.clone().requires_grad_(True) for x in inputs["primitives"]))


@pytest.mark.parametrize("kind", MAGNITUDES)
def test_forward_plain_equals_the_chain(kind):
    inputs = _inputs()
    magnitude = _magnitude(inputs, kind)
    blocking.STATISTICS.clear()
    ours = _route(inputs, magnitude)
    (_, route_kept), = blocking.STATISTICS
    theirs = _chain(inputs, magnitude)
    (_, chain_kept), = list(blocking.STATISTICS)[1:]
    for x, y in zip(ours, theirs):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(route_kept, chain_kept)
    num, count, points = inputs["distortions_u"].shape
    on_target, intercepted, unblocked = ours[3:]
    # Rays hit and miss, rows block rays, and a heliostat (1) keeps a candidate in every slot.
    assert 0 < int(intercepted.sum()) < int(on_target.sum()) < num * count * points
    assert int(unblocked.sum()) < num * count * points and bool((unblocked > 0).all())
    assert bool(route_kept.all(dim=1)[1]) and route_kept.shape == (num, K)


def test_trace_forward_plain_gives_the_chains_rays():
    inputs = _inputs()
    directions, distances, e, u, intensities, on_target = blocked_rays.trace_forward_plain(
        *chip_smoke.blocked_trace_arguments(inputs)
    )
    config = render.RenderConfig(bitmap_resolution=BITMAP)
    chain = render.ray_splat_inputs(inputs["tower"], inputs["preferred"], inputs["origins"], inputs["targets"],
                                    inputs["distortions_u"], inputs["distortions_e"], inputs["magnitudes"], config)
    num, count, points = e.shape
    assert torch.equal(directions, chain.ray_directions.reshape(num, count * points, 4))
    assert torch.equal(distances, chain.distances.reshape(num, count * points))
    assert torch.equal(e, chain.bitmap_e) and torch.equal(u, chain.bitmap_u)
    assert torch.equal(intensities, chain.intensities)
    assert torch.equal(on_target, torch.sum(chain.intensities > 0, dim=(1, 2)))
    # Edge rays: valid exactly on the bitmap's edges; back-facing and behind-the-plane rays as the chain has them.
    edges = len(EDGE_VALID)
    invalid = (e[0, :, :edges] == BITMAP[0] - 1) & (u[0, :, :edges] == 0) & (intensities[0, :, :edges] == 0)
    assert (~invalid).tolist() == [EDGE_VALID] * count
    assert bool((distances.reshape(num, count, points)[0, :, :edges][invalid] == 0).all())


def test_sigma_exactly_zero_gives_the_unblocked_intensities():
    inputs = _inputs()
    num, count, points = inputs["distortions_u"].shape
    intensities = torch.rand((num, count, points), generator=torch.Generator().manual_seed(2))
    sigma = torch.zeros((num, count * points))
    w, counts = blocked_rays.epilogue_plain(intensities, sigma, blocking.ALPHA, EXTINCTION, 0.9)
    assert torch.equal(w, intensities * (1.0 - torch.zeros(())) * (1.0 - EXTINCTION) * 0.9)
    assert counts[1].tolist() == [count * points] * num
    grad_intensities, grad_sigma = blocked_rays.epilogue_backward_plain(torch.ones_like(w), intensities, sigma,
                                                                        blocking.ALPHA, EXTINCTION, 0.9)
    assert torch.allclose(grad_intensities, torch.full_like(w, 0.9 * (1.0 - EXTINCTION)))
    torch.testing.assert_close(grad_sigma, -blocking.ALPHA * 0.9 * (1.0 - EXTINCTION) * intensities.reshape(num, -1))


@pytest.mark.parametrize("kind", MAGNITUDES)
def test_backward_plain_matches_autograd_through_the_chain(kind):
    inputs = _inputs()
    magnitude = _magnitude(inputs, kind)
    generator = torch.Generator().manual_seed(3)
    cotangents = [torch.randn(inputs["distortions_u"].shape, generator=generator) for _ in range(3)]
    grads = []
    for fn in (_route, _chain):
        preferred, origins, primitives = _leaves(inputs)
        outputs = fn(inputs, magnitude, preferred, origins, primitives)
        torch.autograd.backward(list(outputs[:3]), cotangents)
        grads.append((preferred.grad, origins.grad, *(x.grad for x in primitives)))
    for ours, theirs in zip(*grads):
        assert ours.shape == theirs.shape and theirs.abs().max() > 0
        torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-5 * float(theirs.abs().max()))
    assert torch.all(grads[0][0][..., 3] == 0) and torch.all(grads[0][1][..., 3] == 0)


def test_backward_plain_passes_gradcheck_in_float64():
    inputs = _inputs(dtype=torch.float64, heliostats=12, rays=2, points=24)
    # Leave out the edge rays: a step of the check would carry them over an edge.
    edges = len(EDGE_VALID)
    for key in ("preferred", "origins"):
        inputs[key] = inputs[key][:, edges:].clone()
    for key in ("distortions_u", "distortions_e"):
        inputs[key] = inputs[key][:, :, edges:]
    preferred, origins, primitives = _leaves(inputs)

    def route(p, o, *corners_spans_normals):
        return _route(inputs, inputs["magnitudes"], p, o, corners_spans_normals)[:3]

    blocking.STATISTICS.clear()
    with torch.no_grad():
        _, _, _, _, intercepted, unblocked = _route(inputs, inputs["magnitudes"])
    assert 0 < int(intercepted.sum()) and int(unblocked.sum()) < inputs["distortions_u"].numel()
    assert int(blocking.STATISTICS[-1][1].sum()) > 0
    assert torch.autograd.gradcheck(route, (preferred, origins, *primitives))


def _normals_for(inputs):
    """Incident light and mirror normals whose reflections are the inputs' preferred directions."""
    num = inputs["preferred"].shape[0]
    incident = torch.tensor([0.0, 1.0, 0.0, 0.0]).expand(num, 4)
    normals = torch.nn.functional.normalize(inputs["preferred"] - incident[:, None, :], dim=-1)
    return incident, normals


def _trace(inputs, tower=None, **options):
    incident, normals = _normals_for(inputs)
    return render.trace_rays(
        inputs["tower"] if tower is None else tower, inputs["origins"], normals, incident, inputs["targets"],
        inputs["distortions_u"], inputs["distortions_e"], inputs["magnitudes"], inputs["primitives"], inputs["own"],
        _config(inputs, **options),
    )


def _old_route(tower, preferred, points, targets, du, de, magnitude, config, primitives, own):
    """The compacted route as ``trace_rays`` took it before: the PyTorch chain."""
    chain = render.ray_splat_inputs(tower, preferred, points, targets, du, de, magnitude, config, primitives, own)
    return (chain.bitmap_e, chain.bitmap_u, chain.final_intensities, torch.sum(chain.intensities > 0, dim=(1, 2)),
            torch.sum(chain.final_intensities > 0, dim=(1, 2)), torch.sum(chain.blocked < 1e-3, dim=(1, 2)))


@pytest.mark.parametrize("ray_chunk", [1, None], ids=["split", "whole"])
def test_trace_rays_equals_the_chain_with_and_without_ray_chunks(monkeypatch, ray_chunk):
    inputs = _inputs(rays=2)
    results = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(render, "blocked_splat_inputs", _old_route)
        origins = inputs["origins"].clone().requires_grad_(True)
        flux, *factors = _trace(dict(inputs, origins=origins), ray_chunk=ray_chunk)
        weights = torch.linspace(0.5, 1.5, flux[0].numel()).reshape(flux.shape[1:])
        (flux * weights).sum().backward()
        results.append((flux.detach(), factors, origins.grad))
    (flux, factors, grad), (old_flux, old_factors, old_grad) = results
    assert torch.equal(flux, old_flux) and all(torch.equal(x, y) for x, y in zip(factors, old_factors))
    assert float(factors[2].min()) < 1.0  # some rays blocked
    torch.testing.assert_close(grad, old_grad, rtol=0, atol=1e-5 * float(old_grad.abs().max()))


def test_kept_candidates_equal_select_blocking_candidates_on_the_aim1000_corner_field():
    """The route's statistics (plain here, the kernel's on the card in phase 20) give each
    heliostat the candidates that the chain's rays give select_blocking_candidates."""
    _, _, workload, config = benchmark_run.cell(chip_smoke.REPO, chip_smoke.BLOCKED_CELL)
    positions = field_arrays(config["field"])["positions"]
    keep = (positions[:, 0] >= -48.0) & (positions[:, 0] <= -42.0) & (positions[:, 1] >= 165.0)
    config["field"].update(heliostats=int(keep.sum()), surface_points=[6, 6], rays=4, bitmap=[32, 32])
    config["program"]["heliostat_chunk"] = 4
    arrays = field_arrays(config["field"])
    arrays["positions"] = np.ascontiguousarray(positions[keep])
    seed = 2**31 + 5
    data = aim_point_job.make_traffic(arrays, workload["traffic_parameters"], seed, CPU)
    entry = aim_point_job.build(config, workload, arrays, data, seed, CPU)
    inputs = chip_smoke.blocked_inputs_from_trace(chip_smoke.captured_trace_inputs(entry))
    forward = blocked_rays.trace_forward_plain(*chip_smoke.blocked_trace_arguments(inputs))
    statistics = blocked_rays.corridor_statistics(
        inputs["preferred"], inputs["origins"], inputs["distortions_u"], inputs["distortions_e"], forward[0],
        forward[1], None,
    )
    _, kept = chip_smoke.blocked_route_sigma(inputs, forward[0], forward[1], statistics)
    assert kept == chip_smoke.aten_kept_candidates(inputs)
    assert len(kept) == 4 and sum(map(len, kept)) > 4 and inputs["primitives"][0].shape[0] == 8


def _counted(monkeypatch):
    calls = {name: 0 for name in PLAIN + ("ray_forward", "ray_backward", "chain")}

    def counted(name, module, attribute):
        fn = getattr(module, attribute)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, attribute, wrapper)

    for name in PLAIN:
        counted(name, blocked_rays, name)
    counted("ray_forward", rays, "rays_forward_plain")
    counted("ray_backward", rays, "rays_backward_plain")
    counted("chain", render, "ray_splat_inputs")
    return calls


def _small_distortions(size, seed=chip_smoke.SEED + 20):
    points = 4 * size["surface_points"][0] * size["surface_points"][1]
    rng = np.random.RandomState(seed)
    return rng.normal(0.0, 1e-2, (2, size["heliostats"], size["rays"], points)).astype(np.float32)


def _expected(forwards: int, backwards: int, chain: int = 0, ray_forward: int = 0, ray_backward: int = 0):
    expected = {name: forwards if "backward" not in name else backwards for name in PLAIN}
    return dict(expected, ray_forward=ray_forward, ray_backward=ray_backward, chain=chain)


@pytest.mark.parametrize("route", ["compacted", "flat", "off"])
def test_trace_rays_route_choice(monkeypatch, route):
    """chip_smoke.blocked_route_launches' counts on the CPU: the compacted route runs each
    forward 3 times a checkpointed ray chunk (forward, recompute, the render without a
    gradient) and each backward once; the flat route and no blocking run none of it, and the
    ray pair runs only without blocking, as before."""
    calls = _counted(monkeypatch)
    before = dict(rays.LAUNCHES), dict(blocked_rays.LAUNCHES)
    options = {"compacted": dict(blocking_active=True, blocking_candidates=K),
               "flat": dict(blocking_active=True, blocking_candidates=None), "off": {}}[route]
    size = chip_smoke.SMALL
    chip_smoke.small_step(CPU, _small_distortions(size), None, size, **options)
    chunks = size["rays"] // size["ray_chunk"]
    expected = {
        "compacted": _expected(3 * chunks, chunks),
        "flat": _expected(0, 0, chain=3 * chunks),
        "off": _expected(0, 0, ray_forward=3 * chunks, ray_backward=chunks),
    }[route]
    assert calls == expected
    assert (dict(rays.LAUNCHES), dict(blocked_rays.LAUNCHES)) == before


def test_trace_rays_keeps_the_chain_on_a_tower_with_a_cylinder(monkeypatch):
    calls = _counted(monkeypatch)
    inputs = _inputs()
    tower = chip_smoke.mixed_tower(CPU)
    flux, *_ = _trace(dict(inputs, targets=torch.zeros_like(inputs["targets"])), tower=tower)
    assert calls == _expected(0, 0, chain=1) and float(flux.sum()) > 0


@pytest.mark.parametrize("chunk", [None, 2], ids=["unchunked", "chunk2"])
def test_aim_point_launches_two_forwards_and_one_backward_a_chunk(monkeypatch, chunk):
    """An optimize() call of 2 epochs on 4 heliostats: each forward of the route as often as
    the sigma forward (chip_smoke.plant_aim_point_launches: 2 a checkpointed heliostat chunk
    and epoch, the recompute's included), each backward as often as the sigma backward."""
    calls = _counted(monkeypatch)
    scenario = chip_smoke.aim_point_scenario(CPU, 4, (3, 3), 2, row_spacing=chip_smoke.DENSE_ROW_SPACING)
    optimizer = chip_smoke.aim_point_optimizer(
        scenario, chip_smoke.aim_point_ground_truth((32, 32), CPU), 1, K, (32, 32), heliostat_chunk=chunk
    )
    optimizer.optimize("kl_divergence")
    chunks = 2 if chunk else 1
    sigma = chip_smoke.plant_aim_point_launches(2, chunks, K)
    assert calls == _expected(sigma["blocking_sigma_forward"], sigma["blocking_sigma_backward"])
    if chunk:
        assert sigma["blocking_sigma_forward"] == chunks * (1 + 2 * 2) and sigma["blocking_sigma_backward"] == 2 * 2


def test_saves_only_its_inputs_and_nothing_without_a_gradient():
    inputs = _inputs()
    preferred = inputs["preferred"].clone().requires_grad_(True)
    arguments = (preferred, inputs["origins"], inputs["distortions_u"], inputs["distortions_e"], inputs["tower"],
                 inputs["targets"], inputs["magnitudes"], BITMAP)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: packed.append(x) or x, lambda x: x):
        with torch.no_grad():
            blocked_rays.blocked_trace(*arguments)
        assert packed == []
        blocked_rays.blocked_trace(*arguments)
    given = [preferred, inputs["origins"], inputs["distortions_u"], inputs["distortions_e"], inputs["targets"],
             inputs["magnitudes"]]
    assert len(packed) == len(given) and all(x is y for x, y in zip(packed, given))


def test_strided_angles_equal_contiguous_ones():
    inputs = _inputs()
    assert not inputs["distortions_u"].is_contiguous()
    contiguous = dict(inputs, distortions_u=inputs["distortions_u"].contiguous(),
                      distortions_e=inputs["distortions_e"].contiguous())
    results = []
    for case in (inputs, contiguous):
        preferred, origins, primitives = _leaves(case)
        e, u, w, *counts = _route(case, case["magnitudes"], preferred, origins, primitives)
        (e.sum() + 2 * u.sum() + 3 * w.sum()).backward()
        results.append((e, u, w, *counts, preferred.grad, origins.grad))
    for ours, theirs in zip(*results):
        assert torch.equal(ours, theirs)


def test_refuses_a_gradient_of_the_tower_or_the_magnitude():
    inputs = _inputs()
    arguments = list(chip_smoke.blocked_trace_arguments(inputs))
    with pytest.raises(ValueError, match="no gradient"):
        blocked_rays.blocked_trace(*arguments[:6], torch.tensor(1.0, requires_grad=True), arguments[7])
    with pytest.raises(ValueError, match="angles"):
        blocked_rays.blocked_trace(arguments[0], arguments[1], arguments[2][:, :, 1:], arguments[3][:, :, 1:],
                                   *arguments[4:])
    with pytest.raises(ValueError, match="sigma"):
        blocked_rays.blocked_epilogue(torch.ones(2, 3, 4), torch.ones(2, 11), 100.0, 0.0, 1.0)


def test_a_process_that_never_traces_with_blocking_does_not_import_the_module():
    code = """
import sys, torch
from artist_tpu_torch.field.solar_tower import SolarTower
from artist_tpu_torch.raytracing import render
import artist_tpu_torch.optim.aim_point_optimizer, artist_tpu_torch.optim.kinematics_reconstructor
import artist_tpu_torch.optim.surface_reconstructor
zeros = lambda *shape: torch.zeros(shape)
tower = SolarTower(planar_centers=torch.tensor([[0.0, -3.0, 45.0, 1.0]]),
                   planar_normals=torch.tensor([[0.0, 1.0, 0.0, 0.0]]), planar_dimensions=torch.tensor([[10.0, 10.0]]),
                   cylindrical_centers=zeros(0, 4), cylindrical_axes=zeros(0, 4), cylindrical_normals=zeros(0, 4),
                   cylindrical_radii=zeros(0), cylindrical_heights=zeros(0), cylindrical_opening_angles=zeros(0),
                   planar_names=("receiver",))
points = torch.tensor([[[0.0, 40.0, 2.0, 1.0]] * 3])
normals = torch.nn.functional.normalize(torch.tensor([[[0.0, 0.2, 1.0, 0.0]] * 3]), dim=-1)
incident = torch.tensor([[0.0, 1.0, -0.5, 0.0]])
angles = torch.zeros((1, 2, 3))
render.trace_rays(tower, points, normals, incident, torch.tensor([0]), angles, angles,
                  config=render.RenderConfig(bitmap_resolution=(16, 16)))
print("artist_tpu_torch.kernels.blocked_rays" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=chip_smoke.REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"

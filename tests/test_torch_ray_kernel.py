"""The ray kernel pair's plain versions (``artist_tpu_torch/kernels/rays.py``) on the CPU.

The plain forward is held to the PyTorch chain it replaces
(``render.ray_splat_inputs``), the hand-derived plain backward to autograd
through that chain and to ``gradcheck`` in float64, and ``trace_rays`` to its
choice of route. ``chip_smoke.py`` phase 19 holds the CUDA kernels to these plain
versions on the card, on the same inputs (``chip_smoke.ray_chunk_inputs``).

Tolerances: the plain forward computes the chain's products and sums in the
chain's order, so it equals it bit for bit; the backward sums its terms in
another order than autograd, so it agrees to fp32 round-off of the largest
gradient entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from artist_tpu_torch.kernels import rays
from artist_tpu_torch.raytracing import render

CPU = torch.device("cpu")
BITMAP = (64, 48)
EXTINCTION = 0.1
REFLECTIVITY = render.DEFAULT_MIRROR_REFLECTIVITY
# On ray_tower's receiver: valid (on an edge, the corner, the centre, from behind) or not
# (a float step past an edge, back-facing, grazing), in ray_edge_cases' order.
EDGE_VALID = [True, False, True, False, True, False, True, False, True, False, False, True, True]


def _inputs(heliostats=4, rays_=3, points=40, seed=5, dtype=torch.float32):
    return chip_smoke.ray_chunk_inputs(heliostats, rays_, points, CPU, seed, dtype)


def _magnitude(inputs, kind):
    return {"float": 1.7, "scalar tensor": torch.tensor(1.7), "per heliostat": inputs["magnitudes"]}[kind]


def _arguments(inputs, magnitude):
    return (inputs["preferred"], inputs["origins"], inputs["distortions_u"], inputs["distortions_e"],
            inputs["tower"], inputs["targets"], magnitude, BITMAP, EXTINCTION, REFLECTIVITY)


def _chain(inputs, magnitude, preferred=None, origins=None):
    config = render.RenderConfig(bitmap_resolution=BITMAP, ray_extinction_factor=EXTINCTION)
    return render.ray_splat_inputs(
        inputs["tower"], inputs["preferred"] if preferred is None else preferred,
        inputs["origins"] if origins is None else origins, inputs["targets"],
        inputs["distortions_u"], inputs["distortions_e"], magnitude, config,
    )


MAGNITUDES = ["float", "scalar tensor", "per heliostat"]


@pytest.mark.parametrize("kind", MAGNITUDES)
def test_forward_plain_equals_the_chain(kind):
    inputs = _inputs()
    magnitude = _magnitude(inputs, kind)
    e, u, w, counts = rays.rays_forward_plain(*_arguments(inputs, magnitude))
    chain = _chain(inputs, magnitude)
    assert torch.equal(e, chain.bitmap_e) and torch.equal(u, chain.bitmap_u)
    assert torch.equal(w, chain.final_intensities)
    assert torch.equal(counts[0], torch.sum(chain.intensities > 0, dim=(1, 2)))
    assert torch.equal(counts[1], torch.sum(chain.final_intensities > 0, dim=(1, 2)))
    # Rays hit and miss, on both targets.
    assert 0 < int(counts[1].sum()) < e.numel() and counts.dtype == torch.int64
    assert set(inputs["targets"].tolist()) == {0, 1}


def test_edge_rays_valid_exactly_on_the_bitmap():
    inputs = _inputs()
    e, u, w, _ = rays.rays_forward_plain(*_arguments(inputs, 1.0))
    edges = len(EDGE_VALID)
    invalid = (e[0, :, :edges] == BITMAP[0] - 1) & (u[0, :, :edges] == 0) & (w[0, :, :edges] == 0)
    assert (~invalid).tolist() == [EDGE_VALID] * e.shape[1]
    # Zero angles: the edges land exactly on the bitmap's first and last columns and rows.
    assert e[0, 0, 0] == BITMAP[0] - 1 and e[0, 0, 2] == 0 and u[0, 0, 4] == 0 and u[0, 0, 6] == BITMAP[1] - 1


@pytest.mark.parametrize("kind", MAGNITUDES)
def test_backward_plain_matches_autograd_through_the_chain(kind):
    inputs = _inputs()
    magnitude = _magnitude(inputs, kind)
    preferred = inputs["preferred"].clone().requires_grad_(True)
    origins = inputs["origins"].clone().requires_grad_(True)
    chain = _chain(inputs, magnitude, preferred, origins)
    generator = torch.Generator().manual_seed(3)
    cotangents = [torch.randn(chain.bitmap_e.shape, generator=generator) for _ in range(3)]
    torch.autograd.backward([chain.bitmap_e, chain.bitmap_u, chain.final_intensities], cotangents)
    grads = rays.rays_backward_plain(*_arguments(inputs, magnitude), *cotangents)
    for ours, theirs in zip(grads, (preferred.grad, origins.grad)):
        assert ours.shape == theirs.shape and theirs.abs().max() > 0
        torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-5 * float(theirs.abs().max()))
        assert torch.all(ours[..., 3] == 0)


def test_backward_plain_passes_gradcheck_in_float64():
    inputs = _inputs(heliostats=2, rays_=2, points=20, seed=9, dtype=torch.float64)
    # Leave out the edge rays: a step of the check would carry them over an edge.
    edges = len(EDGE_VALID)
    for key in ("preferred", "origins"):
        inputs[key] = inputs[key][:, edges:].clone()
    for key in ("distortions_u", "distortions_e"):
        inputs[key] = inputs[key][:, :, edges:]
    preferred = inputs["preferred"].requires_grad_(True)
    origins = inputs["origins"].requires_grad_(True)

    def chunk(p, o):
        return rays.ray_chunk(p, o, inputs["distortions_u"], inputs["distortions_e"], inputs["tower"],
                              inputs["targets"], inputs["magnitudes"], BITMAP, EXTINCTION, REFLECTIVITY)[:3]

    assert 0 < int(rays.ray_chunk(preferred.detach(), origins.detach(), inputs["distortions_u"],
                                  inputs["distortions_e"], inputs["tower"], inputs["targets"], 1.0, BITMAP,
                                  EXTINCTION, REFLECTIVITY)[4].sum())
    assert torch.autograd.gradcheck(chunk, (preferred, origins))


def test_strided_angles_equal_contiguous_ones():
    inputs = _inputs()
    assert not inputs["distortions_u"].is_contiguous()
    contiguous = dict(inputs, distortions_u=inputs["distortions_u"].contiguous(),
                      distortions_e=inputs["distortions_e"].contiguous())
    results = []
    for case in (inputs, contiguous):
        preferred = case["preferred"].clone().requires_grad_(True)
        origins = case["origins"].clone().requires_grad_(True)
        e, u, w, on_target, intercepted = rays.ray_chunk(
            preferred, origins, case["distortions_u"], case["distortions_e"], case["tower"], case["targets"],
            case["magnitudes"], BITMAP, EXTINCTION, REFLECTIVITY,
        )
        (e.sum() + 2 * u.sum() + 3 * w.sum()).backward()
        results.append((e, u, w, on_target, intercepted, preferred.grad, origins.grad))
    for ours, theirs in zip(*results):
        assert torch.equal(ours, theirs)


def test_saves_only_its_inputs_and_nothing_without_a_gradient():
    inputs = _inputs()
    preferred = inputs["preferred"].clone().requires_grad_(True)
    origins = inputs["origins"].clone().requires_grad_(True)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: packed.append(x) or x, lambda x: x):
        with torch.no_grad():
            rays.ray_chunk(preferred, origins, inputs["distortions_u"], inputs["distortions_e"], inputs["tower"],
                           inputs["targets"], inputs["magnitudes"], BITMAP, EXTINCTION, REFLECTIVITY)
        assert packed == []
        rays.ray_chunk(preferred, origins, inputs["distortions_u"], inputs["distortions_e"], inputs["tower"],
                       inputs["targets"], inputs["magnitudes"], BITMAP, EXTINCTION, REFLECTIVITY)
    given = [preferred, origins, inputs["distortions_u"], inputs["distortions_e"], inputs["targets"],
             inputs["magnitudes"]]
    assert len(packed) == len(given) and all(x is y for x, y in zip(packed, given))


def test_counts_launches_of_kernels_only():
    before = dict(rays.LAUNCHES)
    inputs = _inputs()
    preferred = inputs["preferred"].clone().requires_grad_(True)
    e, *_ = rays.ray_chunk(preferred, inputs["origins"], inputs["distortions_u"], inputs["distortions_e"],
                           inputs["tower"], inputs["targets"], 1.0, BITMAP, EXTINCTION, REFLECTIVITY)
    e.sum().backward()
    assert rays.LAUNCHES == before


def test_kernel_magnitude_shapes():
    assert rays._magnitude_args(0.5, 3) == (None, 0, 0.5)
    one = torch.tensor([[[2.0]]])
    assert rays._magnitude_args(one, 3)[1:] == (0, 0.0)
    assert rays._magnitude_args(torch.ones(3, 1, 1), 3)[1] == 1
    for shape in ((3,), (1, 1, 3), (3, 2, 1), (2, 1, 1)):
        with pytest.raises(ValueError, match="ray_magnitude"):
            rays._magnitude_args(torch.ones(shape), 3)


def test_refuses_a_gradient_of_the_tower_or_the_magnitude():
    inputs = _inputs()
    arguments = [inputs["preferred"], inputs["origins"], inputs["distortions_u"], inputs["distortions_e"],
                 inputs["tower"], inputs["targets"], 1.0, BITMAP, EXTINCTION, REFLECTIVITY]
    tower = dataclasses.replace(inputs["tower"], planar_normals=inputs["tower"].planar_normals.requires_grad_(True))
    with pytest.raises(ValueError, match="no gradient"):
        rays.ray_chunk(*arguments[:4], tower, *arguments[5:])
    with pytest.raises(ValueError, match="no gradient"):
        rays.ray_chunk(*arguments[:6], torch.tensor(1.0, requires_grad=True), *arguments[7:])
    with pytest.raises(ValueError, match="angles"):
        rays.ray_chunk(arguments[0], arguments[1], arguments[2][:, :, 1:], arguments[3][:, :, 1:], *arguments[4:])


def _counted(monkeypatch):
    calls = {"ray_forward": 0, "ray_backward": 0, "chain": 0}

    def counted(name, module, attribute):
        fn = getattr(module, attribute)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, attribute, wrapper)

    counted("ray_forward", rays, "rays_forward_plain")
    counted("ray_backward", rays, "rays_backward_plain")
    counted("chain", render, "ray_splat_inputs")
    return calls


def _small_distortions(size, seed=chip_smoke.SEED + 19):
    points = 4 * size["surface_points"][0] * size["surface_points"][1]
    rng = np.random.RandomState(seed)
    return rng.normal(0.0, 1e-2, (2, size["heliostats"], size["rays"], points)).astype(np.float32)


@pytest.mark.parametrize("ray_chunk", [chip_smoke.SMALL["ray_chunk"], None], ids=["checkpointed", "unchunked"])
def test_trace_rays_takes_the_kernels_on_planar_targets_without_blocking(monkeypatch, ray_chunk):
    """chip_smoke.ray_route_launches' counts: 2 forwards and 1 backward a checkpointed chunk,
    1 and 1 unchunked, and 1 forward a chunk without a gradient."""
    calls = _counted(monkeypatch)
    size = dict(chip_smoke.SMALL, ray_chunk=ray_chunk)
    chip_smoke.small_step(CPU, _small_distortions(size), None, size)
    chunks = 1 if ray_chunk is None else size["rays"] // ray_chunk
    recompute = 0 if ray_chunk is None else chunks
    assert calls == {"ray_forward": 2 * chunks + recompute, "ray_backward": chunks, "chain": 0}


def test_trace_rays_keeps_the_chain_with_blocking(monkeypatch):
    """Blocking never takes the ray pair: the flat route keeps the PyTorch chain; the compacted
    route takes its own kernels (tests/test_torch_blocked_ray_kernel.py)."""
    calls = _counted(monkeypatch)
    distortions = _small_distortions(chip_smoke.SMALL)
    chip_smoke.small_step(CPU, distortions, None, chip_smoke.SMALL, blocking_active=True, blocking_candidates=None)
    chunks = chip_smoke.SMALL["rays"] // chip_smoke.SMALL["ray_chunk"]
    assert calls == {"ray_forward": 0, "ray_backward": 0, "chain": 3 * chunks}
    calls.update(dict.fromkeys(calls, 0))
    chip_smoke.small_step(CPU, distortions, None, chip_smoke.SMALL, blocking_active=True)
    assert calls == {"ray_forward": 0, "ray_backward": 0, "chain": 0}


def test_trace_rays_keeps_the_chain_on_a_mixed_tower(monkeypatch):
    calls = _counted(monkeypatch)
    size = chip_smoke.SMALL_MIXED
    chip_smoke.small_mixed_trace(CPU, _small_distortions(size))
    assert calls == {"ray_forward": 0, "ray_backward": 0, "chain": size["rays"] // size["ray_chunk"]}

"""The block-window splat on rays in place, cut into blocks through a point order.

The render step hands the dynamic-window splat its ``[M, r, P]`` ray streams as
they are, with the order of the surface points (``point_tile_order``) that
cuts the ray blocks; the JAX package splats a point-major copy of the same
rays (``artist_tpu/raytracing/render.py``: swap to ``[M, P, r]``, take the
points in the order). Here the same numpy rays go through JAX's
``bilinear_splat`` with ``method="pallas_fp32"`` and ``block_window`` on that
copy (its kernels in interpret mode on the CPU) and through the port's
``splat_dynamic_window`` on the streams in place; the port's cotangents are
held against JAX's mapped back through the order. Blocks are 64 rays on both
sides on a 32 x 48 map with a 16-row window, so a few hundred rays make
several blocks, fitting and falling back, with a ragged last block, and with
3 rays a point blocks straddle points.

Tolerances: the windows come from the same fp32 coordinates by the same rules
and must be equal; bitmaps and cotangents sum fp32 deposits in other orders,
so they agree to 1e-6 of the largest entry of each output, as in
``tests/test_torch_splat_window.py``.
"""

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import artist_tpu.kernels.splat_pallas as splat_pallas
import chip_smoke
from artist_tpu.raytracing.splatting import bilinear_splat as jax_bilinear_splat
from artist_tpu_torch.kernels import splat_window
from artist_tpu_torch.raytracing import render
from artist_tpu_torch.raytracing.splatting import point_tile_order
from artist_tpu_torch.scenario.synthetic import make_synthetic_scenario

splat_kernels = importlib.import_module("artist_tpu_torch.kernels.splat")

REPO = Path(__file__).resolve().parent.parent
RESOLUTION = (48, 32)  # (width_e, height_u)
HEIGHT, WIDTH = RESOLUTION[1], RESOLUTION[0]
BLOCK = 64
WINDOW = 16
HELIOSTATS = 3
POINT_GRID = (6, 6)  # 36 points, one facet, in 3 x 3 tiles
TILE = 3


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(splat_pallas, "DYN_RAY_BLOCK", BLOCK)
    monkeypatch.setattr(splat_window, "RAY_BLOCK", BLOCK)


def _streams(rays_per_point: int, seed: int = 0):
    """``[M, r, P]`` rays: each point's rays around a centre that moves smoothly over the
    point grid (so that tile-ordered blocks are compact), one heliostat's spot spread
    over the whole map (its blocks fall back), a few rays out of bounds and one
    zero-weight ray."""
    rng = np.random.RandomState(seed)
    points = POINT_GRID[0] * POINT_GRID[1]
    row, col = np.divmod(np.arange(points), POINT_GRID[1])
    centre_u = 4 + 2 * row[None, None, :] + 2 * np.arange(HELIOSTATS)[:, None, None]
    centre_e = 6 + 6 * col[None, None, :]
    shape = (HELIOSTATS, rays_per_point, points)
    u = centre_u + 0.7 * rng.standard_normal(shape)
    e = centre_e + 0.7 * rng.standard_normal(shape)
    u[1] = rng.uniform(0, HEIGHT - 1, shape[1:])
    e[1] = rng.uniform(0, WIDTH - 1, shape[1:])
    u[0, 0, :3] = -4.0
    e[2, -1, -2:] = WIDTH + 5.0
    w = rng.rand(*shape)
    w[0, 1, 7] = 0.0
    return tuple(x.astype(np.float32) for x in (e, u, w))


def _order() -> np.ndarray:
    return np.asarray(point_tile_order(*POINT_GRID, 1, TILE))


def _point_major(x: np.ndarray, order: np.ndarray | None) -> np.ndarray:
    """JAX's render step's copy: ``[M, r, P]`` -> ``[M, P * r]``, the points in ``order``."""
    x = np.swapaxes(x, 1, 2)
    if order is not None:
        x = x[:, order]
    return np.ascontiguousarray(x.reshape(x.shape[0], -1))


def _in_place(x: np.ndarray, order: np.ndarray | None, rays_per_point: int) -> np.ndarray:
    """The inverse of :func:`_point_major`: ``[M, P * r]`` -> ``[M, r, P]``."""
    x = np.swapaxes(x.reshape(x.shape[0], -1, rays_per_point), 1, 2)
    if order is None:
        return x
    out = np.empty_like(x)
    out[:, :, order] = x
    return out


def _assert_close_to_scale(mine, theirs, name, relative=1e-6):
    scale = max(float(np.abs(theirs).max()), 1e-9)
    np.testing.assert_allclose(mine / scale, theirs / scale, rtol=0, atol=relative, err_msg=name)


CASES = {
    "r4_tiles": (4, True),  # 144 rays: 2 full blocks and a ragged one of 16
    "r3_tiles": (3, True),  # 108 rays: blocks straddle points; a ragged block of 44
    "r4_no_order": (4, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_vjp_and_windows_in_place_match_jax(case):
    rays_per_point, tiled = CASES[case]
    e, u, w = _streams(rays_per_point)
    order = _order() if tiled else None
    g = np.random.RandomState(1).rand(HELIOSTATS, HEIGHT, WIDTH).astype(np.float32)
    copies = [jnp.asarray(_point_major(x, order)) for x in (e, u, w)]
    out_jax, vjp = jax.vjp(
        lambda *x: jax_bilinear_splat(*x, RESOLUTION, flip_up_down=False, method="pallas_fp32", block_window=WINDOW),
        *copies,
    )
    grads_jax = [_in_place(np.asarray(x), order, rays_per_point) for x in vjp(jnp.asarray(g))]
    point_order = None if order is None else torch.tensor(order, dtype=torch.int32)
    tensors = [torch.tensor(x, requires_grad=True) for x in (e, u, w)]
    out = splat_window.splat_dynamic_window(*tensors, RESOLUTION, WINDOW, point_order=point_order)
    out.backward(torch.tensor(g))
    assert np.isfinite(out.detach().numpy()).all() and float(out.detach().sum()) > 0
    _assert_close_to_scale(out.detach().numpy(), np.asarray(out_jax), "flux")
    for tensor, theirs, name in zip(tensors, grads_jax, ("de", "du", "dw")):
        assert tensor.grad.shape == tensor.shape
        _assert_close_to_scale(tensor.grad.numpy(), theirs, name)
    assert tensors[2].grad[0, 1, 7] > 0, "the zero-weight ray lost its dw"
    # The windows: the port's through the order, JAX's of its padded point-major copy.
    padded = [splat_pallas._pad_rays(x, -10.0, BLOCK) for x in copies[:2]]
    ou_jax, fits_jax = splat_pallas._dyn_offsets(*padded, HEIGHT, WIDTH, WINDOW, BLOCK)
    ou, fits = splat_window.dyn_offsets(torch.tensor(e), torch.tensor(u), HEIGHT, WIDTH, WINDOW, point_order=point_order)
    np.testing.assert_array_equal(ou.numpy(), np.asarray(ou_jax))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(fits_jax))
    assert 0 < int(fits.sum()) < fits.numel(), "some blocks must fit and some fall back"


@pytest.mark.parametrize("rays_per_point", [4, 3])
def test_sequence_blocks_cut_the_point_major_sequence(rays_per_point):
    """Ray (j, p) sits at position k of the order with p = order[k], so it is ray k r + j of
    the sequence; a ray of a 3-ray point can open a block that its point's other rays
    leave."""
    order = _order()
    ids, blocks = splat_window.sequence_blocks(rays_per_point, order.size, BLOCK, torch.tensor(order))
    sequence = _point_major(np.arange(rays_per_point * order.size).reshape(1, rays_per_point, -1), order)[0]
    expected = np.empty(sequence.size, dtype=np.int64)
    expected[sequence] = np.arange(sequence.size) // BLOCK
    np.testing.assert_array_equal(ids.numpy(), expected)
    assert blocks == -(-sequence.size // BLOCK)
    with pytest.raises(ValueError, match="permutation"):
        splat_window.sequence_blocks(rays_per_point, order.size, BLOCK, torch.zeros(order.size, dtype=torch.long))


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_vjp_is_the_full_splat_gather(case):
    """Why the card runs row 2's kernel for row 4: the windowed VJP (``_dyn_bwd``'s port)
    equals the full splat's gather on the rays in place, for fitting and fallback blocks."""
    rays_per_point, tiled = CASES[case]
    e, u, w = (torch.tensor(x) for x in _streams(rays_per_point, seed=2))
    order = torch.tensor(_order()) if tiled else None
    g = torch.tensor(np.random.RandomState(3).randn(HELIOSTATS, HEIGHT, WIDTH).astype(np.float32))
    windowed = splat_window.splat_dynamic_window_backward_plain(e, u, w, g, HEIGHT, WIDTH, WINDOW, None, order)
    full = splat_kernels.splat_backward_plain(*(x.reshape(HELIOSTATS, -1) for x in (e, u, w)), g, HEIGHT, WIDTH)
    for mine, theirs, name in zip(windowed, full, ("de", "du", "dw")):
        _assert_close_to_scale(mine.numpy(), theirs.reshape(mine.shape).numpy(), name)
    _, fits = splat_window.dyn_offsets(e, u, HEIGHT, WIDTH, WINDOW, point_order=order)
    assert 0 < int(fits.sum()) < fits.numel()


def test_bad_point_orders_raise():
    e, u, w = (torch.tensor(x) for x in _streams(4))
    with pytest.raises(ValueError, match="point_order must be"):
        splat_window.splat_dynamic_window(e, u, w, RESOLUTION, WINDOW, point_order=torch.arange(5))
    with pytest.raises(ValueError, match="point_order must be"):
        splat_window.splat_dynamic_window(e, u, w, RESOLUTION, WINDOW, point_order=torch.arange(36.0))
    with pytest.raises(ValueError, match=r"must be \[M, r, P\]"):
        splat_window.splat_dynamic_window(*(x.reshape(HELIOSTATS, -1) for x in (e, u, w)), RESOLUTION, WINDOW,
                                          point_order=torch.arange(36))


# --------------------------------------------------------------------------- #
# The render step: no ray stream is reordered for the block window.
# --------------------------------------------------------------------------- #

STEP = dict(heliostats=2, surface_points=(5, 5), rays=4, ray_chunk=2, bitmap=(32, 32))
STEP_BLOCK_WINDOW = dict(splat_block_window=16, splat_point_layout=(5, 5, 4), splat_point_tile=5)


def _step_inputs(**options):
    scenario = make_synthetic_scenario(
        number_of_heliostats=STEP["heliostats"], number_of_surface_points_per_facet=STEP["surface_points"],
        number_of_rays=STEP["rays"], device="cpu",
    )
    points = 4 * STEP["surface_points"][0] * STEP["surface_points"][1]
    rng = np.random.RandomState(5)
    du, de = (torch.tensor(rng.normal(0.0, 3e-3, (STEP["heliostats"], STEP["rays"], points)).astype(np.float32))
              for _ in range(2))
    inputs = chip_smoke.step_inputs(scenario, du, de, STEP["surface_points"], STEP["bitmap"], STEP["ray_chunk"])
    return dataclasses.replace(inputs, config=dataclasses.replace(inputs.config, **options))


def test_block_window_trace_reorders_no_ray_stream():
    """``chip_smoke.py`` phase 10's count on the CPU: the block-window step (forward,
    checkpointed recompute and backward) reads no ray stream through an index of its
    points or rays, as the full splat's step does not; a point-major copy of the three
    streams counts three."""
    assert not hasattr(render, "point_major")
    block_window = _step_inputs(**STEP_BLOCK_WINDOW)
    assert chip_smoke.ray_stream_reorders(block_window) == 0
    assert chip_smoke.ray_stream_reorders(_step_inputs()) == 0
    e, _, _ = chip_smoke.first_chunk_rays(block_window)
    points = 4 * STEP["surface_points"][0] * STEP["surface_points"][1]
    with chip_smoke.CountRayStreamReorders(e.numel(), points) as mode:
        chip_smoke.first_chunk_rays(block_window, point_major=True)
    assert mode.count == 3


def test_block_window_trace_equals_the_point_major_splat():
    """The chunk's splat in place with the order equals the plain splat of the point-major
    copy that the JAX package makes, and its windows are that copy's."""
    inputs = _step_inputs(**STEP_BLOCK_WINDOW)
    e, u, w = chip_smoke.first_chunk_rays(inputs)
    num, chunk = e.shape[0], inputs.config.ray_chunk
    streams = tuple(x.reshape(num, chunk, -1) for x in (e, u, w))
    order = render.point_permutation(inputs.config, "cpu")
    assert order.dtype == torch.int32
    height, width = STEP["bitmap"][1], STEP["bitmap"][0]
    window = STEP_BLOCK_WINDOW["splat_block_window"]
    copy = chip_smoke.first_chunk_rays(inputs, point_major=True)
    in_place = splat_window.splat_dynamic_window_forward_plain(*streams, height, width, window, None, order)
    reference = splat_window.splat_dynamic_window_forward_plain(*copy, height, width, window)
    _assert_close_to_scale(in_place.numpy(), reference.numpy(), "flux")
    assert torch.equal(
        torch.stack(splat_window.dyn_offsets(*streams[:2], height, width, window, point_order=order)),
        torch.stack(splat_window.dyn_offsets(*copy[:2], height, width, window)),
    )


# --------------------------------------------------------------------------- #
# The 2-D window of the formulation tool (row 13): the plan that the kernel repeats.
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_splat_formulation_bench_2d", REPO / "tools" / "splat_formulation_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("rays", ["tool", "edges"])
def test_window_2d_offsets_equal_jax_dyn2d_forward(jax_tool, monkeypatch, rays):
    """The port's 2-D windows (rows 8-aligned, columns 128-aligned) against the offsets that
    JAX's ``dyn2d_forward`` hands its Pallas kernel, caught at its ``pallas_call``."""
    block, resolution = 256, (256, 256)
    monkeypatch.setattr(jax_tool, "BLOCK", block)
    if rays == "tool":
        e, u, w = (x.numpy() for x in jax_tool_rays())
    else:
        e, u, w = (x.numpy() for x in chip_smoke.window_edge_rays(*resolution, torch.device("cpu")))
    captured = {}
    pallas_call = jax_tool.pl.pallas_call

    def capturing(*args, **kwargs):
        call = pallas_call(*args, **kwargs)

        def run(ou, oe, fits, *rest):
            captured.update(ou=np.asarray(ou), oe=np.asarray(oe), fits=np.asarray(fits))
            return call(ou, oe, fits, *rest)

        return run

    monkeypatch.setattr(jax_tool.pl, "pallas_call", capturing)
    jax_tool.dyn2d_forward(*(jnp.asarray(x) for x in (e, u, w)), resolution)
    ou, oe, fits = splat_window.window_2d_offsets(torch.tensor(e), torch.tensor(u), *resolution[::-1], block=block)
    np.testing.assert_array_equal(ou.numpy(), captured["ou"])
    np.testing.assert_array_equal(oe.numpy(), captured["oe"])
    np.testing.assert_array_equal(fits.numpy(), captured["fits"])
    if rays == "tool":
        assert 0 < int(fits.sum()) < fits.numel(), "some blocks must fit and some fall back"


def jax_tool_rays():
    """The tool's rays at a small size (2 heliostats x 8 rays x 20 x 20 x 4 points)."""
    from artist_tpu_torch.tools import splat_formulation_bench as tool

    return tool.flagship_rays(heliostats=2, rays=8, points=20, device="cpu")

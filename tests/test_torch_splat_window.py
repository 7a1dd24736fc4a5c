"""The port's windowed splats against the JAX package's Pallas routes.

The same numpy rays go through the JAX package's ``bilinear_splat`` with
``method="pallas_fp32"`` (its kernels in interpret mode on the CPU, as
``tests/kernels/test_splat_dynamic_window.py`` runs them) and through the
port on CPU tensors, which takes the kernels' plain PyTorch versions. JAX's
CPU default (``"scatter"``) ignores both window options; the port follows the
Pallas route on every device, so that is what it is held against.

Blocks are 256 rays on both sides (``splat_pallas.DYN_RAY_BLOCK`` and the
port's ``RAY_BLOCK``), so a few hundred rays span several blocks, fitting and
falling back. Tolerances: the windows are computed from the same fp32
coordinates by the same rules and must be equal; the bitmaps and gradients
sum fp32 deposits in other orders (a one-hot matmul against a 4-tap scatter),
so they agree to 1e-6 of the largest entry of each output.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import artist_tpu.kernels.splat_pallas as splat_pallas
import chip_smoke
from artist_tpu.field import heliostat_group as jax_hg
from artist_tpu.field.solar_tower import get_centers_of_target_areas as jax_centers
from artist_tpu.nurbs import create_nurbs_evaluation_grid as jax_grid
from artist_tpu.nurbs import evaluate_nurbs_surfaces as jax_nurbs
from artist_tpu.optim import losses as jax_losses
from artist_tpu.raytracing import render as jax_render
from artist_tpu.raytracing.splatting import bilinear_splat as jax_bilinear_splat
from artist_tpu.raytracing.splatting import point_tile_order as jax_point_tile_order
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu_torch.convert import scenario_from_numpy

from artist_tpu_torch.kernels import splat_window
from artist_tpu_torch.raytracing.splatting import bilinear_splat, point_tile_order

splat_kernels = importlib.import_module("artist_tpu_torch.kernels.splat")

RESOLUTION = (256, 256)
BLOCK = 256
WINDOW = 96


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(splat_pallas, "DYN_RAY_BLOCK", BLOCK)
    monkeypatch.setattr(splat_window, "RAY_BLOCK", BLOCK)


def _mixed_rays():
    """tests/kernels/test_splat_dynamic_window.py's rays: compact blocks that fit,
    a dispersed one that falls back, out-of-bounds rows and columns."""
    rng = np.random.RandomState(0)
    num = 3
    u = np.concatenate(
        [30 + 8 * rng.rand(num, 512), 5 + 200 * rng.rand(num, 256), 120 + 10 * rng.rand(num, 232)], axis=1
    ).astype(np.float32)
    e = (250 * rng.rand(num, 1000)).astype(np.float32)
    u[:, :17] = -5.0
    e[:, 40:50] = 300.0
    w = rng.rand(num, 1000).astype(np.float32)
    return e, u, w


def _edge_rays():
    """chip_smoke.py's edge cases (integers, the last valid cell, NaN, +-inf, 1e30,
    zero weights) among random rays, and a block whose largest u sits in the last
    valid row: the window's edges."""
    e, u, w = (x.numpy() for x in chip_smoke.edge_case_rays(*RESOLUTION, torch.device("cpu")))
    u = u.copy()
    u[:, 300:556] = np.linspace(160.0, 254.9, 256, dtype=np.float32)
    return e, u, w


def _zero_weight_rays():
    """One zero-weight ray far outside its block's window: its dw must survive."""
    rng = np.random.RandomState(7)
    u = (30 + 8 * rng.rand(1, 256)).astype(np.float32)
    e = (100 + 20 * rng.rand(1, 256)).astype(np.float32)
    w = rng.rand(1, 256).astype(np.float32)
    u[0, 13], e[0, 13], w[0, 13] = 200.3, 50.2, 0.0
    return e, u, w


RAYS = {"mixed": _mixed_rays, "edges": _edge_rays, "zero_weight": _zero_weight_rays}


def _jax_splat(e, u, w, **kwargs):
    return jax_bilinear_splat(e, u, w, RESOLUTION, flip_up_down=False, method="pallas_fp32", **kwargs)


def _jax_forward_and_vjp(e, u, w, g, **kwargs):
    out, vjp = jax.vjp(lambda *x: _jax_splat(*x, **kwargs), *(jnp.asarray(x) for x in (e, u, w)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_forward_and_vjp(e, u, w, g, **kwargs):
    tensors = [torch.tensor(x, requires_grad=True) for x in (e, u, w)]
    out = bilinear_splat(*tensors, RESOLUTION, flip_up_down=False, **kwargs)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in tensors]


def _cotangent(num, seed=1):
    return np.random.RandomState(seed).rand(num, RESOLUTION[1], RESOLUTION[0]).astype(np.float32)


def _assert_close_to_scale(mine, theirs, name, relative=1e-6):
    scale = max(float(np.abs(theirs).max()), 1e-9)
    np.testing.assert_allclose(mine / scale, theirs / scale, rtol=0, atol=relative, err_msg=name)


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_dyn_offsets_equal_jax(rays):
    e, u, _ = RAYS[rays]()
    padded = [splat_pallas._pad_rays(jnp.asarray(x), -10.0, BLOCK) for x in (e, u)]
    ou_jax, fits_jax = splat_pallas._dyn_offsets(*padded, RESOLUTION[1], RESOLUTION[0], WINDOW, BLOCK)
    ou, fits = splat_window.dyn_offsets(torch.tensor(e), torch.tensor(u), RESOLUTION[1], RESOLUTION[0], WINDOW)
    np.testing.assert_array_equal(ou.numpy(), np.asarray(ou_jax))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(fits_jax))


@pytest.mark.parametrize("rays", ["piled_rays", "origin_change_rays"])
@pytest.mark.parametrize("block", [BLOCK, 1024])
def test_chip_smoke_window_inputs_offsets_equal_jax(rays, block):
    """The rays that ``chip_smoke.py`` phase 3d adds (thousands of deposits on a few pixels;
    a window origin that changes at nearly every block, with a fallback and an empty
    block between equal origins) get the TPU's windows, at the test's blocks and at the
    card's 1,024-ray blocks; at the latter the checks they feed are not vacuous."""
    e, u, _ = getattr(chip_smoke, rays)(*RESOLUTION, torch.device("cpu"))
    padded = [splat_pallas._pad_rays(jnp.asarray(x.numpy()), -10.0, block) for x in (e, u)]
    ou_jax, fits_jax = splat_pallas._dyn_offsets(*padded, RESOLUTION[1], RESOLUTION[0], WINDOW, block)
    ou, fits = splat_window.dyn_offsets(e, u, RESOLUTION[1], RESOLUTION[0], WINDOW, block)
    np.testing.assert_array_equal(ou.numpy(), np.asarray(ou_jax))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(fits_jax))
    if block == 1024:
        assert 0 < int(fits.sum()) < fits.numel()
        if rays == "origin_change_rays":
            fitting_origins = ou[fits.bool()]
            assert int((fitting_origins[1:] != fitting_origins[:-1]).sum()) > fits.numel() // 2


@pytest.mark.parametrize(
    "rays, band_rows",
    [
        (40_000, 128),  # the block-window step's chunk: 40 ray blocks, 2 bands of 128 rows
        (15_000_000, 86),  # 14,649 ray blocks take 117 KB: 3 bands of 86 rows
        (40_000_000, None),  # 39,063 ray blocks leave no room for a row
    ],
    ids=["flagship", "many_blocks", "too_many_blocks"],
)
def test_window_band_rows(rays, band_rows):
    """The row-window forward's bands: ``splat.band_layout`` of what the ray blocks' extents
    leave of the H100's per-block shared memory (232,448 bytes)."""
    if band_rows is None:
        with pytest.raises(ValueError, match="does not fit"):
            splat_window.window_band_rows(rays, *RESOLUTION, 232_448, 1024)
        return
    assert splat_window.window_band_rows(rays, *RESOLUTION, 232_448, 1024) == band_rows
    blocks = -(-rays // 1024)
    assert 4 * band_rows * RESOLUTION[0] + splat_kernels.BAND_PAD_BYTES + 8 * blocks <= 232_448


def test_mixed_rays_fit_and_fall_back():
    """The check below is not vacuous: some blocks take the window, some the full map."""
    e, u, _ = _mixed_rays()
    _, fits = splat_window.dyn_offsets(torch.tensor(e), torch.tensor(u), RESOLUTION[1], RESOLUTION[0], WINDOW)
    assert 0 < int(fits.sum()) < fits.numel()


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_dynamic_window_forward_and_vjp_match_jax(rays):
    e, u, w = RAYS[rays]()
    g = _cotangent(e.shape[0])
    out_jax, grads_jax = _jax_forward_and_vjp(e, u, w, g, block_window=WINDOW)
    out, grads = _torch_forward_and_vjp(e, u, w, g, block_window=WINDOW)
    assert np.isfinite(out).all() and out.sum() > 0
    _assert_close_to_scale(out, out_jax, "flux")
    for mine, theirs, name in zip(grads, grads_jax, ("de", "du", "dw")):
        _assert_close_to_scale(mine, theirs, name)
    if rays == "zero_weight":
        assert grads[2][0, 13] > 0, "the zero-weight ray lost its dw"


def test_dynamic_window_equals_the_full_splat():
    """Exact for every input: the same bitmaps and gradients as the full splat's plain version."""
    e, u, w = _mixed_rays()
    g = _cotangent(e.shape[0], seed=2)
    out_full, grads_full = _torch_forward_and_vjp(e, u, w, g)
    out, grads = _torch_forward_and_vjp(e, u, w, g, block_window=WINDOW)
    _assert_close_to_scale(out, out_full, "flux")
    for mine, theirs, name in zip(grads, grads_full, ("de", "du", "dw")):
        _assert_close_to_scale(mine, theirs, name)


def test_plain_version_asserts_that_deposits_lie_in_their_window():
    """The plain forward adds a fitting block's taps into its own window slice and
    refuses a window that would miss one of them."""
    e, u, w = (torch.tensor(x) for x in _mixed_rays())
    height, width = RESOLUTION[1], RESOLUTION[0]
    ou, fits = splat_window.dyn_offsets(e, u, height, width, WINDOW)
    args = (e, u, w, height, width, BLOCK, WINDOW, width)
    splat_window._window_forward_plain(*args, ou, torch.zeros_like(ou), fits)
    shifted = torch.where(fits.bool() & (ou > 0), ou + 8, ou)
    with pytest.raises(AssertionError, match="outside its window"):
        splat_window._window_forward_plain(*args, shifted, torch.zeros_like(ou), fits)


@pytest.mark.parametrize("layout", [(50, 50, 4, 10), (10, 10, 4, 5)], ids=["50x50_tile10", "10x10_tile5"])
def test_point_tile_order_equals_jax(layout):
    assert point_tile_order(*layout) == jax_point_tile_order(*layout)


@pytest.mark.parametrize("window", [12, 264], ids=["not_a_multiple_of_8", "taller_than_the_bitmap"])
def test_bad_windows_raise(window):
    e, u, w = (torch.tensor(x) for x in _mixed_rays())
    with pytest.raises(ValueError, match="multiple of 8 and <= height"):
        bilinear_splat(e, u, w, RESOLUTION, block_window=window)
    with pytest.raises(ValueError, match="multiple of 8 and <= height"):
        splat_window.dyn_offsets(e, u, RESOLUTION[1], RESOLUTION[0], window)
    with pytest.raises(ValueError, match="multiple of 8 and <= height"):
        splat_pallas._dyn_forward(*(jnp.asarray(x.numpy()) for x in (e, u, w)), RESOLUTION, window, jnp.float32)


def test_block_window_takes_precedence_over_window():
    e, u, w = (torch.tensor(x) for x in _mixed_rays())
    both = bilinear_splat(e, u, w, RESOLUTION, window=32, block_window=WINDOW)
    dynamic = bilinear_splat(e, u, w, RESOLUTION, block_window=WINDOW)
    torch.testing.assert_close(both, dynamic, rtol=0, atol=0)


def test_gradcheck_fp64_away_from_integers():
    rng = np.random.RandomState(5)
    height, width = 16, 9
    # Fractional parts in [0.1, 0.9]; two blocks of 8 rays, one spanning all rows.
    e = rng.randint(0, width - 1, size=(2, 16)) + rng.uniform(0.1, 0.9, size=(2, 16))
    u = rng.randint(0, 4, size=(2, 16)) + rng.uniform(0.1, 0.9, size=(2, 16))
    u[:, 8:] += rng.randint(0, height - 5, size=(2, 8))
    w = rng.uniform(0.2, 1.5, size=(2, 16))
    inputs = tuple(torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (e, u, w))
    _, fits = splat_window.dyn_offsets(*inputs[:2], height, width, 8, block=8)
    assert 0 < int(fits.sum()) < fits.numel()
    assert torch.autograd.gradcheck(
        lambda e, u, w: splat_window.BilinearSplatDynamicWindow.apply(e, u, w, height, width, 8, 8), inputs
    )


def _concentrated_rays():
    """Spots of a few dozen pixels, with a tail of rays far from the centre."""
    rng = np.random.RandomState(3)
    num, n = 3, 600
    e = (100 + 12 * rng.randn(num, n)).astype(np.float32)
    u = (140 + 9 * rng.randn(num, n)).astype(np.float32)
    e[:, :20] = rng.uniform(0, 255, (num, 20))
    w = rng.rand(num, n).astype(np.float32)
    return e, u, w


def test_windowed_splat_matches_jax():
    e, u, w = _concentrated_rays()
    g = _cotangent(e.shape[0], seed=3)
    out_jax, grads_jax = _jax_forward_and_vjp(e, u, w, g, window=32)
    out, grads = _torch_forward_and_vjp(e, u, w, g, window=32)
    _assert_close_to_scale(out, out_jax, "flux")
    for mine, theirs, name in zip(grads, grads_jax, ("de", "du", "dw")):
        _assert_close_to_scale(mine, theirs, name)
    drop = splat_kernels.windowed_drop_fraction(*(torch.tensor(x) for x in (e, u, w)), RESOLUTION, 32)
    drop_jax = splat_pallas.windowed_drop_fraction(*(jnp.asarray(x) for x in (e, u, w)), RESOLUTION, 32)
    assert 0.05 < float(drop) < 0.9, "the window must drop some rays and keep most"
    np.testing.assert_allclose(float(drop), float(drop_jax), rtol=1e-5)
    # A window as large as the bitmap is the full splat.
    full = splat_kernels.splat_windowed(*(torch.tensor(x) for x in (e, u, w)), RESOLUTION, 256)
    np.testing.assert_array_equal(full.numpy(), _torch_forward_and_vjp(e, u, w, g)[0])


# --------------------------------------------------------------------------- #
# The render step with the windows, against the JAX package's trace_rays.
# --------------------------------------------------------------------------- #

HELIOSTATS = 2
POINTS = (10, 10)
STEP_RAYS = 4
BITMAP = (64, 64)
BLOCK_WINDOW = dict(splat_block_window=32, splat_point_layout=(10, 10, 4), splat_point_tile=5)


def _as_dict(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def scenarios():
    jax_scenario = jax_synthetic(
        number_of_heliostats=HELIOSTATS, number_of_surface_points_per_facet=POINTS, number_of_rays=STEP_RAYS
    )
    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position,
        _as_dict(jax_scenario.solar_tower),
        [_as_dict(sun) for sun in jax_scenario.light_sources],
        [_as_dict(group) for group in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names,
        device="cpu",
    )
    rng = np.random.RandomState(13)
    shape = (HELIOSTATS, STEP_RAYS, 4 * POINTS[0] * POINTS[1])
    # A little wider than the sun's 2.1 mrad: the spot spans rows ~6-56 of the
    # 64 x 64 bitmap, most 256-ray blocks fit a 32-row window and some do not.
    du = rng.normal(0.0, 3e-3, shape).astype(np.float32)
    de = rng.normal(0.0, 3e-3, shape).astype(np.float32)
    return jax_scenario, scenario, du, de


def _jax_step(jax_scenario, du, de, ray_chunk, options, ground_truth=None):
    """The flagship step of bench.py from the JAX package at this size, the splat on its Pallas route."""
    group = jax_scenario.heliostat_groups[0]
    tower = jax_scenario.solar_tower
    num = group.number_of_heliostats
    indices = jnp.arange(num, dtype=jnp.int32)
    targets = jnp.zeros(num, jnp.int32)
    incident = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0, 0.0], jnp.float32), (num, 4))
    aim = jax_centers(tower, targets)
    config = jax_render.RenderConfig(
        bitmap_resolution=BITMAP, ray_chunk=ray_chunk, splat_method="pallas_fp32", **options
    )

    def render_fn(control_points):
        active = jax_hg.gather_active(group.replace(nurbs_control_points=control_points), indices)
        points, normals = jax_nurbs(
            active.nurbs_control_points, group.nurbs_degrees, jax_grid(POINTS),
            canting=active.canting, facet_translations=active.facet_translations,
        )
        active = active.replace(surface_points=points.reshape(num, -1, 4), surface_normals=normals.reshape(num, -1, 4))
        aligned_points, aligned_normals = jax_hg.align_surfaces_with_incident_ray_directions(active, aim, incident)[:2]
        return jax_render.trace_rays(
            tower, aligned_points, aligned_normals, incident, targets, jnp.asarray(du), jnp.asarray(de), config=config
        )

    def loss_fn(control_points):
        flux = render_fn(control_points)[0]
        truth = jnp.ones((num, BITMAP[1], BITMAP[0])) if ground_truth is None else jnp.asarray(ground_truth)
        return jnp.sum(jax_losses.kl_divergence_loss(flux, truth)) / num

    return render_fn, loss_fn, group.nurbs_control_points


def _port_inputs(scenario, du, de, ray_chunk, options):
    inputs = chip_smoke.step_inputs(scenario, torch.tensor(du), torch.tensor(de), POINTS, BITMAP, ray_chunk)
    return dataclasses.replace(inputs, config=dataclasses.replace(inputs.config, **options))


WINDOW_ROUTES = {"block_window": BLOCK_WINDOW, "window": dict(splat_window=32)}


@pytest.mark.parametrize(
    "route, ray_chunk",
    [("block_window", None), ("block_window", 2), ("window", 2)],
    ids=["block_window-whole", "block_window-chunk2", "window-chunk2"],
)
def test_trace_rays_matches_jax(scenarios, route, ray_chunk):
    """Each package's trace with the window against the same package's without it
    to 1e-5 x max(peak, 1), the JAX package's own tolerance for its route
    (tests/kernels/test_splat_dynamic_window.py); the port's against JAX's no
    further apart than the two packages' full-splat traces are, plus that. The
    full-splat traces differ by the packages' fp32 geometry (NURBS, alignment,
    intersection), ~1.3e-4 of the peak at one rim pixel here."""
    jax_scenario, scenario, du, de = scenarios
    cp = scenario.heliostat_groups[0].nurbs_control_points
    fluxes = {}
    for name, options in (("window", WINDOW_ROUTES[route]), ("full", {})):
        render_fn, _, jax_cp = _jax_step(jax_scenario, du, de, ray_chunk, options)
        theirs = [np.asarray(x) for x in render_fn(jax_cp)]
        inputs = _port_inputs(scenario, du, de, ray_chunk, options)
        with torch.no_grad():
            ours = [x.numpy() for x in chip_smoke.render(cp, inputs)]
        for mine, other in zip(ours[1:], theirs[1:]):
            np.testing.assert_allclose(mine, other, rtol=1e-6, atol=0)
        fluxes[name] = ours[0], theirs[0]
    (flux, flux_jax), (full, full_jax) = fluxes["window"], fluxes["full"]
    assert flux.shape == (HELIOSTATS, BITMAP[1], BITMAP[0]) and np.count_nonzero(flux) > 100
    exact = 1e-5 * max(float(full_jax.max()), 1.0)
    if route == "block_window":
        np.testing.assert_allclose(flux, full, rtol=0, atol=exact)
        np.testing.assert_allclose(flux_jax, full_jax, rtol=0, atol=exact)
    else:
        assert not np.allclose(flux, full, rtol=0, atol=exact), "the 32-pixel window must drop some rays"
    geometry = float(np.abs(full - full_jax).max())
    assert geometry <= 2e-4 * float(full_jax.max())
    np.testing.assert_allclose(flux, flux_jax, rtol=0, atol=geometry + exact)
    if route == "block_window":
        # The blocks of the tile-ordered rays: most fit the 32-row window, some do not.
        e, u, _ = chip_smoke.first_chunk_rays(inputs, point_major=True)
        _, fits = splat_window.dyn_offsets(e, u, BITMAP[1], BITMAP[0], 32)
        assert 0 < int(fits.sum()) < fits.numel()


@pytest.mark.parametrize("ray_chunk", [None, 2], ids=["whole", "chunk2"])
def test_block_window_loss_and_gradient_match_jax(scenarios, ray_chunk):
    """The KL loss and its control-point gradient under a ground truth of ones on
    the spot and zeros off it (ROADMAP.md section 3: under all ones, rim pixels
    holding one deposit make both ill-conditioned across the packages' geometry).
    As for the trace: each package's window route equals its full splat (loss
    rtol 1e-6, gradient 1e-5 of its largest entry), and the port's is no further
    from JAX's than the full routes are from each other (loss rtol 1e-4 on top,
    gradient 1e-5 of its largest entry); those differ by the packages' fp32
    geometry, ~5e-3 of the largest gradient entry here."""
    jax_scenario, scenario, du, de = scenarios
    render_fn, _, jax_cp = _jax_step(jax_scenario, du, de, ray_chunk, BLOCK_WINDOW)
    flux = np.asarray(render_fn(jax_cp)[0])
    spot = (flux > 0.05 * flux.max(axis=(1, 2), keepdims=True)).astype(np.float32)
    cp = scenario.heliostat_groups[0].nurbs_control_points
    results = {}
    for name, options in (("window", BLOCK_WINDOW), ("full", {})):
        _, loss_fn, _ = _jax_step(jax_scenario, du, de, ray_chunk, options, ground_truth=spot)
        loss_jax, grad_jax = jax.value_and_grad(loss_fn)(jax_cp)
        inputs = _port_inputs(scenario, du, de, ray_chunk, options)
        control_points = cp.clone().requires_grad_(True)
        loss = chip_smoke.surface_loss(control_points, dataclasses.replace(inputs, ground_truth=torch.tensor(spot)))
        loss.backward()
        results[name] = (loss.item(), control_points.grad.numpy()), (float(loss_jax), np.asarray(grad_jax))
    ((loss, grad), (loss_jax, grad_jax)), ((loss_full, grad_full), (loss_jax_full, grad_jax_full)) = (
        results["window"], results["full"]
    )
    scale = float(np.abs(grad_jax_full).max())
    assert scale > 0
    for (window_loss, window_grad), (full_loss, full_grad) in (
        ((loss, grad), (loss_full, grad_full)), ((loss_jax, grad_jax), (loss_jax_full, grad_jax_full))
    ):
        np.testing.assert_allclose(window_loss, full_loss, rtol=1e-6)
        np.testing.assert_allclose(window_grad, full_grad, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(loss, loss_jax, rtol=abs(loss_full / loss_jax_full - 1) + 1e-4)
    geometry = float(np.abs(grad_full - grad_jax_full).max())
    assert geometry <= 1e-2 * scale
    np.testing.assert_allclose(grad, grad_jax, rtol=0, atol=geometry + 1e-5 * scale)


def test_checkpointed_chunks_rerun_the_dynamic_window_forward(scenarios, monkeypatch):
    """The launch counts chip_smoke.py asserts with the block window: per chunk two
    dynamic-window forwards and one backward, and no full-splat call."""
    _, scenario, du, de = scenarios
    calls = {"forward": 0, "backward": 0, "full": 0}

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args):
            calls[key] += 1
            return fn(*args)

        monkeypatch.setattr(module, name, wrapper)

    counted(splat_window, "splat_dynamic_window_forward_plain", "forward")
    counted(splat_window, "splat_dynamic_window_backward_plain", "backward")
    counted(splat_kernels, "splat_forward_plain", "full")
    counted(splat_kernels, "splat_backward_plain", "full")
    control_points = scenario.heliostat_groups[0].nurbs_control_points.clone().requires_grad_(True)
    chip_smoke.surface_loss(control_points, _port_inputs(scenario, du, de, 1, BLOCK_WINDOW)).backward()
    assert calls == {"forward": 2 * STEP_RAYS, "backward": STEP_RAYS, "full": 0}


def test_plain_path_launches_no_kernel():
    before = dict(splat_window.LAUNCHES)
    e, u, w = (torch.tensor(x, requires_grad=True) for x in _mixed_rays())
    bilinear_splat(e, u, w, RESOLUTION, block_window=WINDOW).sum().backward()
    assert splat_window.LAUNCHES == before


def test_chip_smoke_small_window_steps_run_on_the_cpu():
    """Rehearsal of chip_smoke.py's phase 7c, CPU against CPU."""
    chip_smoke.check_small_window_steps_against_cpu(torch.device("cpu"))

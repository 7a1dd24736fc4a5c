"""The port's bilinear splat against the JAX package's Pallas splat kernel.

The same numpy rays go through ``bilinear_splat_pallas`` (fp32 factors, run in
interpret mode on the CPU as ``tests/kernels/test_splat_pallas.py`` runs it)
and through the port's ``BilinearSplat`` on CPU tensors, which takes the
kernels' plain PyTorch versions. Tolerance: both sides accumulate in fp32 in
different orders (a one-hot matmul against a 4-tap scatter), so values and
gradients agree to ``rtol = atol = 1e-5`` at these magnitudes (pixel sums of
at most a few dozen unit-scale deposits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.kernels.splat_pallas import _splat_bwd, bilinear_splat_pallas
from artist_tpu_torch.kernels import splat_window
from artist_tpu_torch.kernels.splat import (
    LAUNCHES,
    BilinearSplat,
    splat,
    splat_backward_plain,
)
from artist_tpu_torch.raytracing.splatting import bilinear_splat

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_rays(num, n, width, height, seed):
    rng = np.random.RandomState(seed)
    # Interior, boundary and out-of-range coordinates.
    e = rng.uniform(-4, width + 4, size=(num, n)).astype(np.float32)
    u = rng.uniform(-4, height + 4, size=(num, n)).astype(np.float32)
    w = rng.rand(num, n).astype(np.float32)
    return e, u, w


def _edge_rays(width, height):
    """Rays at the kernel's edge cases, one heliostat per row of the table."""
    rows = [
        # (e, u, w)
        (3.0, 5.0, 1.0),  # exact integer coordinates: (-1, +1) derivative factors
        (0.0, 0.0, 0.7),  # the lowest valid cell
        (width - 2 + 0.5, height - 2 + 0.25, 0.9),  # the highest valid cell
        (width - 2.0, 2.0, 1.3),  # integer on the last valid column
        (width - 1.0, 3.5, 1.0),  # e = W - 1: where invalid rays land after the flip
        (4.5, height - 1.0, 1.0),  # u = H - 1: outside the strict bound
        (-0.5, 3.5, 1.0),  # negative e
        (2.5, -1e-3, 1.0),  # negative u just below 0
        (6.25, 7.75, 0.0),  # zero weight, in bounds: still receives dw
        (1.5, 1.5, 0.0),  # zero weight, in bounds
        (10.0, 1.0, 2.0),  # integer both, interior
        (7.999, 8.001, 0.5),  # just below and above integers
    ]
    table = np.asarray(rows, dtype=np.float32)
    return (
        table[None, :, 0].repeat(2, axis=0).copy(),
        table[None, :, 1].repeat(2, axis=0).copy(),
        (table[None, :, 2] * np.array([[1.0], [0.5]], np.float32)).copy(),
    )


def _jax_forward_and_vjp(e, u, w, g, resolution):
    def f(e, u, w):
        return bilinear_splat_pallas(e, u, w, resolution, jnp.float32)

    out, vjp = jax.vjp(f, jnp.asarray(e), jnp.asarray(u), jnp.asarray(w))
    grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch_forward_and_vjp(e, u, w, g, resolution):
    tensors = [torch.tensor(x, requires_grad=True) for x in (e, u, w)]
    out = splat(*tensors, resolution)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in tensors]


@pytest.mark.parametrize("resolution", [(64, 48), (32, 32)], ids=["64x48", "32x32"])
def test_forward_and_vjp_match_pallas(resolution):
    width, height = resolution
    e, u, w = _random_rays(3, 600, width, height, seed=0)
    g = np.random.RandomState(1).randn(3, height, width).astype(np.float32)
    out_jax, grads_jax = _jax_forward_and_vjp(e, u, w, g, resolution)
    out_torch, grads_torch = _torch_forward_and_vjp(e, u, w, g, resolution)
    np.testing.assert_allclose(out_torch, out_jax, **TOL)
    assert out_torch.sum() > 0
    for mine, theirs, name in zip(grads_torch, grads_jax, ("de", "du", "dw")):
        np.testing.assert_allclose(mine, theirs, err_msg=name, **TOL)


def test_edge_cases_match_pallas():
    resolution = (16, 12)
    width, height = resolution
    e, u, w = _edge_rays(width, height)
    g = np.random.RandomState(2).randn(2, height, width).astype(np.float32)
    out_jax, grads_jax = _jax_forward_and_vjp(e, u, w, g, resolution)
    out_torch, grads_torch = _torch_forward_and_vjp(e, u, w, g, resolution)
    np.testing.assert_allclose(out_torch, out_jax, **TOL)
    for mine, theirs, name in zip(grads_torch, grads_jax, ("de", "du", "dw")):
        np.testing.assert_allclose(mine, theirs, err_msg=name, **TOL)

    de, du, dw = grads_torch
    # Rays 4-7 fail the strict bounds: no deposit and no gradient.
    for ray in (4, 5, 6, 7):
        assert de[:, ray].tolist() == du[:, ray].tolist() == dw[:, ray].tolist() == [0, 0]
    # Zero-weight in-bounds rays: no deposit, but dw is the bilinear tap sum.
    assert np.all(dw[:, 8] != 0) and np.all(dw[:, 9] != 0)
    assert np.all(de[:, 8] == 0) and np.all(du[:, 8] == 0)
    # Exact integer coordinates take the one-hot factors: de = w (g[lu, le+1] - g[lu, le]).
    np.testing.assert_allclose(de[:, 0], w[:, 0] * (g[:, 5, 4] - g[:, 5, 3]), rtol=1e-6)
    np.testing.assert_allclose(du[:, 0], w[:, 0] * (g[:, 6, 3] - g[:, 5, 3]), rtol=1e-6)


@pytest.mark.parametrize("rays", ["piled_rays", "band_border_rays"])
def test_chip_smoke_forward_inputs_match_pallas(rays):
    """The rays that ``chip_smoke.py`` phase 3a adds for the band kernel (thousands of
    deposits on a few pixels; taps straddling every band border) through both forwards at
    the flagship resolution. Per pixel of n deposits d: two summation orders differ by at
    most 2.01 (n - 1) u sum|d|, and the two packages round each deposit's three-factor
    product in another order, at most 3 u |d| on each side."""
    e, u, w = (x[:, :4096].contiguous() for x in getattr(chip_smoke, rays)(256, 256, torch.device("cpu")))
    out_jax = torch.tensor(np.asarray(
        bilinear_splat_pallas(*(jnp.asarray(x.numpy()) for x in (e, u, w)), (256, 256), jnp.float32)
    ))
    out_torch = splat(e, u, w, (256, 256))
    _, taps = chip_smoke._valid_taps(e, u, 256, 256)
    deposits = torch.bincount(taps, minlength=out_torch.numel()).reshape(out_torch.shape)
    magnitude = splat(e, u, w.abs(), (256, 256))
    limit = (2.01 * (deposits - 1).clamp(min=0) + 6) * chip_smoke.UNIT_ROUNDOFF * magnitude
    assert float(out_torch.sum()) > 0 and int(deposits.max()) > (1000 if rays == "piled_rays" else 1)
    assert bool(((out_torch - out_jax).abs() <= limit).all())


def test_nonfinite_and_huge_coordinates_deposit_nothing():
    resolution = (16, 12)
    e, u, w = _random_rays(2, 40, *resolution, seed=3)
    bad_e = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 3.5, 3.5, 3.5], np.float32)
    bad_u = np.array([4.5, 4.5, 4.5, 4.5, 4.5, np.nan, np.inf, 3e38], np.float32)
    e_all = np.concatenate([e, np.tile(bad_e, (2, 1))], axis=1)
    u_all = np.concatenate([u, np.tile(bad_u, (2, 1))], axis=1)
    w_all = np.concatenate([w, np.ones((2, bad_e.size), np.float32)], axis=1)
    g = np.random.RandomState(4).randn(2, resolution[1], resolution[0]).astype(np.float32)

    out_all, grads_all = _torch_forward_and_vjp(e_all, u_all, w_all, g, resolution)
    out_finite, grads_finite = _torch_forward_and_vjp(e, u, w, g, resolution)
    np.testing.assert_array_equal(out_all, out_finite)
    for mine, finite in zip(grads_all, grads_finite):
        np.testing.assert_array_equal(mine[:, : e.shape[1]], finite)
        assert np.all(mine[:, e.shape[1] :] == 0)
    # The finite rays alone still agree with the Pallas kernel.
    out_jax, _ = _jax_forward_and_vjp(e, u, w, g, resolution)
    np.testing.assert_allclose(out_finite, out_jax, **TOL)


def test_gradcheck_fp64_away_from_integers():
    rng = np.random.RandomState(5)
    width, height = 9, 7
    # Fractional parts in [0.1, 0.9]: the splat is smooth there.
    e = rng.randint(0, width - 1, size=(2, 10)) + rng.uniform(0.1, 0.9, size=(2, 10))
    u = rng.randint(0, height - 1, size=(2, 10)) + rng.uniform(0.1, 0.9, size=(2, 10))
    w = rng.uniform(0.2, 1.5, size=(2, 10))
    inputs = tuple(torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (e, u, w))
    assert torch.autograd.gradcheck(
        lambda e, u, w: BilinearSplat.apply(e, u, w, height, width), inputs
    )


def test_bilinear_splat_flattens_rays_and_flips_rows():
    resolution = (16, 12)
    e, u, w = _random_rays(2, 24, *resolution, seed=6)
    shaped = [torch.tensor(x.reshape(2, 4, 6)) for x in (e, u, w)]
    flat = splat(*(torch.tensor(x) for x in (e, u, w)), resolution)
    flipped = bilinear_splat(*shaped, resolution, flip_up_down=True)
    unflipped = bilinear_splat(*shaped, resolution, flip_up_down=False)
    torch.testing.assert_close(unflipped, flat, rtol=0, atol=0)
    torch.testing.assert_close(flipped, torch.flip(flat, dims=(1,)), rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    good = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="contiguous"):
        splat(torch.zeros(5, 2).t(), good, good, (8, 8))
    with pytest.raises(ValueError, match="share shape"):
        splat(good, torch.zeros(2, 4), good, (8, 8))
    with pytest.raises(TypeError):
        splat(good.long(), good.long(), good.long(), (8, 8))
    with pytest.raises(ValueError, match="at least 2 x 2"):
        splat(good, good, good, (1, 8))
    meta = torch.zeros(2, 5, device="meta")
    with pytest.raises(ValueError, match="no splat for device type"):
        splat(meta, meta, meta, (8, 8))


def test_plain_path_launches_no_kernel():
    before = dict(LAUNCHES)
    e, u, w = (torch.tensor(x, requires_grad=True) for x in _random_rays(1, 16, 8, 8, seed=7))
    splat(e, u, w, (8, 8)).sum().backward()
    assert LAUNCHES == before


@pytest.mark.parametrize(("rays_per_map", "offset"), [(1001, 0), (3, 1), (1001, 3), (1, 3)])
def test_plain_backward_matches_pallas_bwd_on_ragged_rays_and_offset_views(rays_per_map, offset):
    """The plain backward, which the card's gather is held to, against JAX's ``_splat_bwd``
    at N that is no multiple of 4 (JAX pads the rays to its block and cuts the pad off)
    and with e, u, w and g as views ``offset`` floats into their storage, as phase 3a's
    layout cases hand them to the kernel."""
    resolution = (32, 24)
    width, height = resolution
    e, u, w = _random_rays(3, rays_per_map, width, height, seed=8)
    g = np.random.RandomState(9).randn(3, height, width).astype(np.float32)
    grads_jax = _splat_bwd(resolution, jnp.float32, tuple(jnp.asarray(x) for x in (e, u, w)), jnp.asarray(g))
    views = [chip_smoke.offset_copy(torch.tensor(x), offset) for x in (e, u, w, g)]
    assert all(x.storage_offset() == offset and x.is_contiguous() for x in views)
    grads_torch = splat_backward_plain(*views, height, width)
    for mine, theirs, name in zip(grads_torch, grads_jax, ("de", "du", "dw")):
        assert mine.shape == (3, rays_per_map)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), err_msg=name, **TOL)


H_SECTORS, W_SECTORS = 12, 16  # two 32-byte sectors a row


def _flat_sector(m: int, row: int, col: int) -> int:
    return (m * H_SECTORS * W_SECTORS + row * W_SECTORS + col) // 8


@pytest.mark.parametrize(
    ("rays", "expected"),
    [
        # Two rays whose taps share both rows' sectors: 2 sectors.
        ([(0, 1.5, 1.5), (0, 2.5, 1.25)], {_flat_sector(0, 1, 0), _flat_sector(0, 2, 0)}),
        # Columns 7 and 8 straddle the sector border: 2 sectors in each row.
        ([(0, 7.5, 3.5)], {_flat_sector(0, r, c) for r in (3, 4) for c in (7, 8)}),
        # The last valid cell, lu = H - 2 and le = W - 2, in two maps: the maps' sectors differ.
        ([(0, W_SECTORS - 2.0, H_SECTORS - 2.0), (1, W_SECTORS - 1.5, H_SECTORS - 1.5)],
         {_flat_sector(m, r, W_SECTORS - 1) for m in (0, 1) for r in (H_SECTORS - 2, H_SECTORS - 1)}),
        # Invalid rays count nothing: NaN, infinities, e = W - 1, u = H - 1, negative, huge.
        ([(0, np.nan, 2.5), (0, np.inf, 2.5), (1, -np.inf, 2.5), (0, W_SECTORS - 1.0, 2.5),
          (1, 3.5, H_SECTORS - 1.0), (0, -0.5, 2.5), (1, 1e30, 2.5)], set()),
    ],
    ids=["two rays in one sector", "tap pair across a sector border", "last valid row and column", "invalid rays"],
)
def test_touched_sectors_on_hand_made_rays(rays, expected):
    """``chip_smoke.splat_work``'s count of sectors, which gives row 2's sector floor: the
    distinct (map, row, column // 8) of the valid rays' four taps."""
    e = torch.full((2, len(rays)), -5.0)
    u = torch.full((2, len(rays)), -5.0)
    for i, (m, x, y) in enumerate(rays):
        e[m, i], u[m, i] = x, y
    work = chip_smoke.splat_work(e, u, torch.ones_like(e), H_SECTORS, W_SECTORS)
    assert work["sectors"] == len(expected)


@pytest.mark.parametrize("in_place", [False, True], ids=["rows 2 [M, N]", "row 4 [M, r, P]"])
def test_chip_smoke_backward_layouts_run_on_the_cpu(in_place):
    """Phases 3a and 3d's layout cases (N = 1, 3, 17, 1,000, 1,001; views at offsets 1 and
    3 floats, and mixed; 256 x 256, 16 x 16 and 8 x 2 maps) through the wrappers' plain
    versions in the kernels' place: every case reaches the check, and the plain version
    passes its own."""
    if in_place:
        def backward(e, u, w, g, height, width):
            return splat_window.splat_dynamic_window_backward_plain(e, u, w, g, height, width, min(96, height))
    else:
        backward = splat_backward_plain
    result = chip_smoke.check_backward_layouts("backward", backward, backward, torch.device("cpu"), in_place)
    cases = (len(chip_smoke.LAYOUT_RAYS) * len(chip_smoke.LAYOUT_OFFSETS) + 1) * len(chip_smoke.LAYOUT_BITMAPS)
    assert result == dict(cases=cases, worst_share=0.0)

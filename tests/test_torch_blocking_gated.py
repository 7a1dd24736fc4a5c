"""The compacted blocking route's sigma at the edges of its gates: the port against JAX's gated Pallas kernels.

``chip_smoke.gated_edge_cases`` builds compacted sigma inputs (six heliostats,
K = 16 or 32 candidate slots) at the edges of the gates: pairs with ``t``
exactly ``t_target`` and one fp32 step either side, ``t_target = -1e30``, gates
that saturate alone or overflow in pairs, ``keep = 0`` slots between kept ones, a
heliostat with nothing kept, kept slots past 15 at K = 32, a NaN origin, an
infinite direction and a ray with ``gbar = 0``. The JAX side runs
``blocking_sigma_pallas_grouped`` (in interpret mode on the CPU: the fused
backward ``_sigma_bwd_fused_kernel`` at K = 16, the split pair at K = 32) and its
VJP; the port's side runs the plain PyTorch versions of the CUDA kernels,
because every tensor here lies on the CPU. ``chip_smoke.py`` phase 3b runs the
same cases through the kernels on the card.

Tolerances, each with its reason: NaN exactly where JAX has NaN. Elsewhere
both sides run the same fp32 formulas in the same order, but XLA contracts and
sums otherwise, and at softness 1000 a pair at a gate's edge moves by ``k du``:
one rounding of ``u`` apart moves a cotangent by up to ~2e-4 of itself, as much
as each side is from the float64 plain version (~2e-4 of each output's peak
here). So each side is held, as ``chip_smoke.py`` holds the kernels on the card,
to at most twice the other's error against float64, in max and in mean, plus
64 ulps of the output's largest entry. The gates at ``t = t_target`` are
decided on exact values (every term of those pairs is a small dyadic number),
so both sides must agree on them exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.kernels import blocking_pallas as jax_pallas
from artist_tpu_torch.kernels import blocking as kernels

PARAMETERS = chip_smoke.GATED_EDGE_PARAMETERS
POINTS = chip_smoke.GATED_EDGE_POINTS


def _jax_gated_sigma(origins, directions, t_target, columns, keep, gbar):
    """JAX's ``blocking_sigma_pallas_grouped`` (interpret mode) and its VJP on the port's
    layout, padded as ``soft_ray_blocking_mask_pallas_compact`` pads each heliostat's
    rays: sigma ``[M, N]``, the origin cotangents summed over each point's rays ``[M, P,
    3]``, the direction cotangents ``[M, N, 3]`` and the column cotangents ``[M, K, 16]``."""
    heliostats, rays = directions.shape[:2]
    points, candidates = origins.shape[1], columns.shape[1]
    unit = math.lcm(jax_pallas.RAY_BLOCK, jax_pallas.BWD_RAY_BLOCK)
    padded = -(-rays // unit) * unit

    def flat(x, value=0.0):
        x = jnp.asarray(x, jnp.float32).reshape(heliostats, rays)
        return jnp.pad(x, ((0, 0), (0, padded - rays)), constant_values=value).reshape(-1)

    origins3 = np.broadcast_to(origins[:, None, :, :3], (heliostats, rays // points, points, 3))
    origins3 = origins3.reshape(heliostats, rays, 3)
    ray_components = tuple(flat(origins3[..., a]) for a in range(3)) + tuple(
        flat(directions[..., a]) for a in range(3)
    )
    valid, gated = flat(np.ones((heliostats, rays))), flat(t_target, -1e30)
    table = tuple(jnp.asarray(columns[..., j].reshape(-1, 1)) for j in range(kernels.NUM_COLUMNS))
    keep_column = jnp.asarray(keep.reshape(-1, 1))
    sigma, vjp = jax.vjp(
        lambda r, c: jax_pallas.blocking_sigma_pallas_grouped(r, valid, gated, c, keep_column, heliostats, *PARAMETERS),
        ray_components, table,
    )
    ray_grads, column_grads = vjp(flat(gbar))
    per_ray = np.stack([np.asarray(g).reshape(heliostats, padded)[:, :rays] for g in ray_grads], axis=-1)
    grad_origins = per_ray[..., :3].reshape(heliostats, rays // points, points, 3).sum(axis=1)
    grad_columns = np.concatenate([np.asarray(g) for g in column_grads], axis=1).reshape(heliostats, candidates, -1)
    sigma = np.asarray(sigma).reshape(heliostats, padded)[:, :rays]
    return sigma, grad_origins, per_ray[..., 3:], grad_columns


def _plain(candidates):
    arrays = [torch.tensor(x) for x in chip_smoke.gated_edge_cases(candidates)]
    inputs, gbar = tuple(arrays[:5]), arrays[5]
    sigma = kernels.sigma_forward_plain(*inputs, *PARAMETERS)
    grads = kernels.sigma_backward_plain(*inputs, gbar, *PARAMETERS)
    return inputs, gbar, sigma, grads


@pytest.mark.parametrize("candidates", [16, 32], ids=["K16_fused", "K32_split"])
def test_gated_edge_cases_match_jax(candidates):
    inputs, gbar, sigma, grads = _plain(candidates)
    theirs = _jax_gated_sigma(*(x.numpy() for x in inputs), gbar.numpy())
    ours = (sigma, grads[0][..., :3], grads[1][..., :3], grads[2])
    wide = tuple(x.double() for x in inputs)
    reference = (kernels.sigma_forward_plain(*wide, *PARAMETERS),) + kernels.sigma_backward_plain(
        *wide, gbar.double(), *PARAMETERS
    )
    reference = (reference[0], reference[1][..., :3], reference[2][..., :3], reference[3])
    for name, mine, other, wide in zip(("sigma", "origins", "directions", "columns"), ours, theirs, reference):
        mine, wide = mine.numpy(), wide.numpy()
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(other), err_msg=f"{name}: NaN pattern")
        np.testing.assert_array_equal(np.isnan(wide), np.isnan(other), err_msg=f"{name}: NaN pattern, float64")
        finite = ~np.isnan(other)
        mine, other, wide = mine[finite], other[finite], wide[finite]
        scale = float(np.abs(other).max())
        assert scale > 0, name
        floor = 64 * 2.0**-24 * scale
        for statistic in (np.max, np.mean):
            error, error_jax = statistic(np.abs(mine - wide)), statistic(np.abs(other - wide))
            assert error <= 2 * error_jax + floor and error_jax <= 2 * error + floor, (name, statistic)
    assert np.isnan(theirs[0]).any()  # the NaN and infinite inputs reach the outputs
    # The gates at t = t_target, decided on exact values: t = 2 against 2, one step
    # below (gated off), one step above; t_target = -1e30.
    np.testing.assert_array_equal(theirs[0][0, [0, POINTS, 1, POINTS + 1]] > 0.99, [True, False, True, False])
    np.testing.assert_array_equal(sigma[0, [POINTS, POINTS + 1]].numpy(), [0.0, 0.0])


@pytest.mark.parametrize("candidates", [16, 32])
def test_gated_edge_cases_semantics(candidates):
    """What each edge case must give in the plain version, which the card's kernels are held to."""
    inputs, gbar, sigma, (grad_origins, grad_directions, grad_columns) = _plain(candidates)
    keep = inputs[4]
    rays = 2 * POINTS
    # Heliostat 1: a gate that saturates alone leaves sigma tiny but not 0 (rays 0-2);
    # two or three that do overflow it to exactly 0 (rays 3-7, 7 at the threshold).
    assert ((sigma[1, :3] > 0) & (sigma[1, :3] < 1e-30)).all()
    assert (sigma[1, 3:8] == 0).all()
    # Heliostat 3 keeps nothing: sigma and its cotangents are exactly 0.
    assert (sigma[3] == 0).all() and (grad_directions[3] == 0).all() and (grad_origins[3] == 0).all()
    assert (grad_columns[3] == 0).all()
    # keep = 0 slots get no column cotangent; every kept slot of a finite heliostat gets one.
    assert (grad_columns[keep == 0] == 0).all()
    finite = [0, 1, 2, 5]
    assert (grad_columns[finite][keep[finite] != 0].abs().amax(dim=-1) > 0).all()
    late = torch.nonzero(keep[5]).flatten()
    assert int(late.min()) >= (16 if candidates == 32 else 14)
    # Heliostat 4: the NaN origin (point 0, both rays) and the infinite direction (ray 1)
    # give NaN; its other rays do not, and the ray with gbar = 0 gets zero cotangents.
    nan_rays = torch.isnan(sigma[4])
    assert nan_rays[[0, POINTS, 1]].all() and int(nan_rays.sum()) == 3
    assert torch.isnan(grad_origins[4, 0]).any() and not torch.isnan(grad_origins[4, 2:]).any()
    assert float(gbar[4, 2]) == 0.0 and (grad_directions[4, 2] == 0).all()
    assert torch.isfinite(sigma[[0, 1, 2, 3, 5]]).all() and sigma.shape == (6, rays)


@pytest.mark.parametrize("candidates", [16, 32])
def test_pairs_the_kernels_leave_early_add_exact_zeros(candidates):
    """What the compacted kernels' early exit relies on: where ``gated_pair_exits`` holds,
    the fp32 pair's sigma and each of its 22 cotangents are exactly 0, so leaving the pair
    after its geometry changes no sum; a pair with a NaN or infinite term never exits.
    Every cause of exit occurs in the edge cases, and so do pairs that take the full path.
    chip_smoke.sigma_pair_counts counts what the kernels skip from the same rule."""
    inputs, gbar, _, _ = _plain(candidates)
    origins, directions, t_target, columns, keep = inputs
    softness, offset, epsilon = PARAMETERS
    rays = kernels._rays(origins, directions)
    causes = dict(beyond=0, overflow=0, weight=0, full=0)
    exits_total = forward_total = 0
    for k in range(columns.shape[1]):
        rows = torch.nonzero(keep[:, k]).flatten()
        if rows.numel() == 0:
            continue
        ray_terms = tuple(x[rows] for x in rays)
        weight = keep[rows, k, None]
        sigma, pair = kernels._pair_terms(ray_terms, columns[rows, k], t_target[rows], softness, offset, epsilon)
        det = 1.0 / columns[rows, k, 15, None]
        exits = kernels.gated_pair_exits(pair, t_target[rows], gbar[rows] * weight, det, softness, offset)
        forward_exits = kernels.gated_pair_exits(pair, t_target[rows], weight, torch.ones_like(det), softness, offset)
        ray_parts, column_parts = kernels._pair_cotangents(
            ray_terms, columns[rows, k], weight, t_target[rows], gbar[rows], softness, offset, epsilon
        )
        assert (sigma[forward_exits] == 0).all()
        for part in ray_parts + column_parts:
            assert (part[exits] == 0).all()
        assert not torch.isnan(sigma[exits | forward_exits]).any()
        causes["beyond"] += int((exits & (pair["t"] > t_target[rows])).sum())
        causes["overflow"] += int((exits & kernels.gates_overflow(pair, softness, offset)).sum())
        causes["weight"] += int((exits & (gbar[rows] == 0)).sum())
        causes["full"] += int((~exits).sum())
        exits_total += int(exits.sum())
        forward_total += int(forward_exits.sum())
    assert all(count > 0 for count in causes.values()), causes
    counts = chip_smoke.sigma_pair_counts(inputs, PARAMETERS, gbar)
    assert counts["heliostats_none_kept"] == 1 and counts["ray_blocks_none_kept"] == 3
    assert counts["kept_pairs"] == int(keep.sum()) * directions.shape[1]
    assert (counts["left_early_backward"], counts["left_early_forward"]) == (exits_total, forward_total)
    zero = counts["zero_beyond_target"] + counts["zero_overflow"] + counts["zero_both"]
    assert 0 < zero <= counts["zero_sigma"] <= counts["kept_pairs"]

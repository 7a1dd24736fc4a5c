"""The flat blocking route: the port against the JAX package's flat Pallas route and its XLA default.

The flat route (``max_candidates=None``, or no target distances) sums each
ray's soft occlusion over every primitive that the AABB cull keeps. The JAX
side runs ``method="pallas"`` (``soft_ray_blocking_mask_pallas`` and
``cull_primitives_pallas``, in interpret mode on the CPU) and ``"xla"`` /
``"auto"`` (the dense route that is the JAX package's CPU default, the same
semantics in the sigmoid form). The port's side runs the plain PyTorch
versions of the CUDA kernels, because every tensor here lies on the CPU.
All inputs come from numpy seeds.

Tolerances, each with its reason:

- the cull is a hard decision computed with the same fp32 operations in the
  same order: equal to JAX's exactly, edge cases included;
- the grazing scene (softness 6, gates active): the mask to 1e-6 and each
  gradient to ``5e-6 x`` its largest entry, JAX's own bound for its Pallas
  kernels against XLA autodiff (``tests/kernels/test_blocking_pallas.py``);
- the dense-row field (softness 1000): flux to ``1e-4`` of its peak, as the
  unblocked render (fp32 geometry, sums in other orders), and the factors,
  which are ray counts, exactly;
- the plain backward against autograd through the plain forward, in float64:
  ``1e-10`` relative to each cotangent's largest entry (they differ by
  float64 rounding only);
- the plain flat sigma and its cotangents against JAX's
  ``blocking_sigma_pallas`` under explicit keep patterns (softness 6):
  ``2e-6`` of each output's largest entry (the same fp32 formulas; they
  differ by ~3e-7); and against the plain versions over the kept primitives
  alone: exactly;
- ``primitive_chunk`` changes nothing: identical results.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from artist_tpu.kernels import blocking_pallas as jax_pallas
from artist_tpu.raytracing import blocking as jax_blocking
from artist_tpu.raytracing import render as jax_render
from artist_tpu_torch.kernels import blocking as kernels
from artist_tpu_torch.raytracing import blocking, render
from test_torch_blocking import (  # noqa: F401  (module-scoped fixtures shared with the compacted route's tests)
    BITMAP,
    HELIOSTATS,
    RAYS,
    _jax_rays,
    _random_sigma_inputs,
    _unit_square,
    dense_rows,
)


@pytest.fixture(scope="module")
def grazing():
    """Rays straddling the edges of two unit squares 1.5 m apart, soft gates active
    (softness 6), with per-ray target distances between the squares and beyond both."""
    heliostats, rays, points = 2, 3, 4
    rng = np.random.RandomState(5)
    origins = np.zeros((heliostats, points, 4))
    origins[..., 3] = 1.0
    origins[:, :, 0] = np.linspace(-0.6, 0.9, points)
    origins[:, :, 2] = 0.3
    directions3 = np.tile([0.05, 1.0, 0.02], (heliostats, rays, points, 1))
    directions3 = directions3 + 0.08 * rng.standard_normal(directions3.shape)
    directions3 /= np.linalg.norm(directions3, axis=-1, keepdims=True)
    directions = np.concatenate([directions3, np.zeros(directions3.shape[:-1] + (1,))], axis=-1)
    corners, spans, normals = (np.stack(p) for p in zip(_unit_square(1.0), _unit_square(2.5)))
    t_target = rng.uniform(1.5, 4.0, (heliostats, rays, points))
    return [x.astype(np.float32) for x in (origins, directions, corners, spans, normals, t_target)]


def _jax_cull(origins, directions, t_target, own, corners):
    """``cull_primitives_pallas`` on the port's layout, padded as ``soft_ray_blocking_mask_pallas`` pads."""
    heliostats, rays, points = directions.shape[:3]
    total = heliostats * rays * points
    padded = -(-total // jax_pallas.RAY_BLOCK) * jax_pallas.RAY_BLOCK

    def flat(x, value=0.0):
        return jnp.pad(jnp.asarray(x, jnp.float32).reshape(-1), (0, padded - total), constant_values=value)

    origins3 = np.broadcast_to(origins[:, None, :, :3], (heliostats, rays, points, 3))
    rays_flat = tuple(flat(origins3[..., a]) for a in range(3)) + tuple(flat(directions[..., a]) for a in range(3))
    valid = flat(np.ones(total))
    own_flat = flat(np.broadcast_to(np.asarray(own)[:, None, None], (heliostats, rays, points)), -1.0)
    corners3 = jnp.asarray(corners)[:, :, :3]
    keep = jax_pallas.cull_primitives_pallas(
        rays_flat, valid, flat(t_target), own_flat, corners3.min(axis=1), corners3.max(axis=1)
    )
    return np.asarray(keep).astype(np.float32)


def _port_cull(origins, directions, t_target, own, corners):
    return blocking.cull_primitives(
        *(torch.tensor(np.asarray(x)) for x in (origins, directions, corners)),
        None if own is None else torch.tensor(np.asarray(own)),
        torch.tensor(np.asarray(t_target)),
    ).numpy()


@pytest.mark.parametrize("owned", [True, False], ids=["own", "no_own"])
def test_plain_cull_matches_jax_on_the_grazing_scene(grazing, owned):
    origins, directions, corners, _, _, t_target = grazing
    own = np.array([0, 1]) if owned else None
    ours = _port_cull(origins, directions, t_target, own, corners)
    theirs = _jax_cull(origins, directions, t_target, np.array([-1, -1]) if own is None else own, corners)
    np.testing.assert_array_equal(ours, theirs)
    if owned:
        # Each heliostat's rays reach both squares; without the other's they keep only one.
        np.testing.assert_array_equal(ours, [1.0, 1.0])
    theirs_short = _jax_cull(origins, directions, np.full_like(t_target, 1.5), np.array([-1, -1]), corners)
    ours_short = _port_cull(origins, directions, np.full_like(t_target, 1.5), None, corners)
    np.testing.assert_array_equal(ours_short, theirs_short)
    np.testing.assert_array_equal(ours_short, [1.0, 0.0])  # the far square lies beyond every target


@pytest.mark.parametrize("owned", [True, False], ids=["own", "no_own"])
def test_plain_cull_matches_jax_on_the_dense_rows(dense_rows, owned):
    jax_side, _, du, de = dense_rows
    directions, distances = _jax_rays(jax_side, du, de)
    points = jax_side[1]
    corners = jax_blocking.create_blocking_primitives_rectangles_by_index(points)[0]
    own = np.arange(HELIOSTATS) if owned else None
    args = (np.asarray(points), np.asarray(directions), np.asarray(distances))
    ours = _port_cull(*args, own, np.asarray(corners))
    theirs = _jax_cull(*args, np.full(HELIOSTATS, -1) if own is None else own, np.asarray(corners))
    np.testing.assert_array_equal(ours, theirs)
    if owned:
        assert 0 < ours.sum() < HELIOSTATS  # some heliostats may block, not all
    else:
        assert ours.sum() == HELIOSTATS  # each heliostat's own rays leave its own box


@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.cull_edge_cases()])
def test_plain_cull_edge_cases_match_jax(case):
    """Own primitive, blocker beyond the target, zero and -1e-12 direction components,
    t_target = -1e30, NaN and infinite directions: the expected flags, and JAX's."""
    (_, origins, directions, t_target, own, aabb, expected), = [c for c in chip_smoke.cull_edge_cases() if c[0] == case]
    heliostats, rays = directions.shape[:2]
    points = origins.shape[1]
    corners = np.stack([aabb[:, :3], aabb[:, 3:]], axis=1)  # the AABB's two corners span it
    directions4 = directions.reshape(heliostats, rays // points, points, 4)
    t4 = t_target.reshape(heliostats, rays // points, points)
    plain = kernels.cull_plain(*(torch.tensor(x) for x in (origins, directions, t_target, own, aabb))).numpy()
    np.testing.assert_array_equal(plain, expected)
    np.testing.assert_array_equal(plain, _jax_cull(origins, directions4, t4, own, corners))


@pytest.mark.parametrize("method", ["pallas", "xla"])
@pytest.mark.parametrize("targets", [True, False], ids=["cull", "no_targets"])
def test_flat_mask_and_gradients_match_jax(grazing, method, targets):
    origins, directions, corners, spans, normals, t_target = grazing
    own = np.array([0, -1])
    weights = np.linspace(0.5, 1.5, origins.shape[1]).astype(np.float32)
    distances = t_target if targets else None

    def jax_loss(o, d, c, s, n):
        mask = jax_blocking.soft_ray_blocking_mask(
            o, d, c, s, n, intersection_distances_target=None if distances is None else jnp.asarray(distances),
            ray_primitive_indices=jnp.asarray(own), softness=6.0, method=method, max_candidates=None,
        )
        return jnp.sum(mask * weights), mask

    jax_args = [jnp.asarray(x) for x in (origins, directions, corners, spans, normals)]
    (_, jax_mask), jax_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*jax_args)

    args = [torch.tensor(x, requires_grad=True) for x in (origins, directions, corners, spans, normals)]
    mask = blocking.soft_ray_blocking_mask(
        *args, intersection_distances_target=None if distances is None else torch.tensor(distances),
        ray_primitive_indices=torch.tensor(own), softness=6.0, max_candidates=None,
    )
    torch.sum(mask * torch.tensor(weights)).backward()

    assert float(mask.detach().mean()) > 0.1  # the scene blocks
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(jax_mask), rtol=0, atol=1e-6)
    for name, arg, expected in zip(("origins", "directions", "corners", "spans", "normals"), args, jax_grads):
        expected = np.asarray(expected)
        scale = np.abs(expected).max()
        # The normals enter only through the plane offset and t; their gradient is smaller.
        assert scale > (1e-4 if name == "normals" else 1e-3), f"vacuous gradient for {name}"
        np.testing.assert_allclose(arg.grad.numpy(), expected, rtol=0, atol=5e-6 * scale, err_msg=name)


def test_cull_removes_the_own_primitive_and_far_blockers(grazing):
    """With target distances the mask differs from the uncut one exactly where the cull
    drops a square: heliostat 0 owns square 0, and targets short of square 1 drop it."""
    origins, directions, corners, spans, normals, _ = grazing
    args = [torch.tensor(x) for x in (origins, directions, corners, spans, normals)]
    short = torch.full(directions.shape[:3], 1.5)
    own = torch.tensor([0, 1])
    uncut = blocking.soft_ray_blocking_mask(*args, softness=6.0, max_candidates=None)
    cut = blocking.soft_ray_blocking_mask(
        *args, intersection_distances_target=short, ray_primitive_indices=own, softness=6.0, max_candidates=None
    )
    # Square 1 lies beyond every target and square 0 is kept by heliostat 1's rays only.
    table = blocking.primitive_table(*args[2:])
    expected_sigma = kernels.sigma_flat_forward_plain(
        args[0], args[1].reshape(2, -1, 4), table, torch.tensor([1.0, 0.0]), 6.0, 0.05, 1e-12
    )
    torch.testing.assert_close(cut, 1.0 - torch.exp(-100.0 * expected_sigma.reshape(cut.shape)), rtol=0, atol=0)
    assert float((uncut - cut).abs().max()) > 0.05


def test_plain_flat_backward_matches_autograd_in_float64():
    inputs, gbar = _random_sigma_inputs(torch.float64)
    origins, directions, _, columns, _ = inputs
    table = columns.reshape(-1, kernels.NUM_COLUMNS).contiguous()  # every candidate a primitive
    keep = torch.ones(table.shape[0], dtype=torch.float64)
    keep[::4] = 0.0
    parameters = (6.0, 0.05, 1e-12)
    leaves = [x.clone().requires_grad_(True) for x in (origins, directions, table)]
    sigma = kernels.sigma_flat_forward_plain(leaves[0], leaves[1], leaves[2], keep, *parameters)
    assert float(sigma.detach().max()) > 0.1  # pairs actually overlap
    torch.sum(sigma * gbar).backward()
    derived = kernels.sigma_flat_backward_plain(origins, directions, table, keep, gbar, *parameters)
    for name, leaf, mine in zip(("origins", "directions", "columns"), leaves, derived):
        scale = float(leaf.grad.abs().max())
        assert scale > 1e-3, name
        torch.testing.assert_close(mine, leaf.grad, rtol=0, atol=1e-10 * scale, msg=name)
    grad_origins, grad_directions, grad_columns = derived
    assert (grad_columns[::4] == 0).all()  # the culled primitives
    assert (grad_directions[..., 3] == 0).all() and (grad_origins[..., 3] == 0).all()


def _keep_pattern(pattern: str, primitives: int) -> np.ndarray:
    keep = np.zeros(primitives, np.float32)
    if pattern == "first":
        keep[0] = 1.0
    elif pattern == "last":
        keep[-1] = 1.0
    elif pattern == "scattered":
        keep[[1, 4, 5, 9, 12]] = 1.0
    elif pattern == "all":
        keep[:] = 1.0
    return keep


def _jax_flat_sigma(origins, directions, table, keep, gbar, parameters):
    """JAX's ``blocking_sigma_pallas`` (interpret mode) and its VJP on the port's layout,
    padded as ``soft_ray_blocking_mask_pallas`` pads: sigma ``[M, N]``, the origin
    cotangents summed over each point's rays ``[M, P, 3]``, the direction cotangents
    ``[M, N, 3]`` and the column cotangents ``[B, 16]``."""
    heliostats, rays = directions.shape[:2]
    points = origins.shape[1]
    total = heliostats * rays
    block = max(jax_pallas.RAY_BLOCK, jax_pallas.BWD_RAY_BLOCK)
    padded = -(-total // block) * block
    primitives = table.shape[0]
    padded_primitives = -(-primitives // jax_pallas.PRIM_TILE) * jax_pallas.PRIM_TILE

    def flat(x):
        return jnp.pad(jnp.asarray(x, jnp.float32).reshape(-1), (0, padded - total))

    origins3 = np.broadcast_to(origins[:, None, :, :3], (heliostats, rays // points, points, 3)).reshape(total, 3)
    ray_components = tuple(flat(origins3[:, a]) for a in range(3)) + tuple(
        flat(directions[..., a]) for a in range(3)
    )
    valid = flat(np.ones(total))
    columns = tuple(
        jnp.pad(jnp.asarray(table[:, j]), (0, padded_primitives - primitives))[:, None] for j in range(16)
    )
    keep_column = jnp.pad(jnp.asarray(keep), (0, padded_primitives - primitives))[:, None]
    sigma, vjp = jax.vjp(
        lambda r, c: jax_pallas.blocking_sigma_pallas(r, valid, c, keep_column, *parameters), ray_components, columns
    )
    ray_grads, column_grads = vjp(flat(gbar))
    per_ray = np.stack([np.asarray(g)[:total] for g in ray_grads], axis=-1).reshape(heliostats, rays, 6)
    grad_origins = per_ray[..., :3].reshape(heliostats, rays // points, points, 3).sum(axis=1)
    grad_columns = np.concatenate([np.asarray(g) for g in column_grads], axis=1)[:primitives]
    return np.asarray(sigma)[:total].reshape(heliostats, rays), grad_origins, per_ray[..., 3:], grad_columns


@pytest.mark.parametrize("pattern", ["none", "first", "last", "scattered", "all"])
def test_flat_sigma_keep_patterns(pattern):
    """What the flat kernels' compaction of kept primitives relies on, for each keep pattern.

    The plain flat sigma and its cotangents equal JAX's ``blocking_sigma_pallas`` with the
    same explicit keep (fp32 on both sides, the same formulas in the same order: 2e-6 of
    each output's largest entry, for XLA's other contractions and summation order). And
    with keep = mask they equal, exactly, the plain versions over ``columns[mask]`` with
    every primitive kept: a dropped primitive adds an exact zero to every sum, its column
    cotangents are exactly 0, and the kept ones are summed in the same ascending order.
    """
    inputs, gbar = _random_sigma_inputs(torch.float32)
    origins, directions, _, columns, _ = inputs
    table = columns.reshape(-1, kernels.NUM_COLUMNS).contiguous()
    keep = torch.tensor(_keep_pattern(pattern, table.shape[0]))
    parameters = (6.0, 0.05, 1e-12)
    sigma = kernels.sigma_flat_forward_plain(origins, directions, table, keep, *parameters)
    grads = kernels.sigma_flat_backward_plain(origins, directions, table, keep, gbar, *parameters)

    theirs = _jax_flat_sigma(*(x.numpy() for x in (origins, directions, table, keep, gbar)), parameters)
    ours = (sigma, grads[0][..., :3], grads[1][..., :3], grads[2])
    for name, mine, other in zip(("sigma", "origins", "directions", "columns"), ours, theirs):
        scale = float(np.abs(other).max())
        np.testing.assert_allclose(mine.numpy(), other, rtol=0, atol=2e-6 * scale, err_msg=name)
    if pattern == "none":
        assert float(sigma.abs().max()) == 0.0 and all(float(g.abs().max()) == 0.0 for g in grads)
    else:
        assert float(sigma.max()) > 0.1  # the kept primitives block

    mask = keep != 0
    compact = table[mask].contiguous()
    ones = torch.ones(compact.shape[0])
    torch.testing.assert_close(
        kernels.sigma_flat_forward_plain(origins, directions, compact, ones, *parameters), sigma, rtol=0, atol=0
    )
    compact_grads = kernels.sigma_flat_backward_plain(origins, directions, compact, ones, gbar, *parameters)
    for name, mine, other in zip(("origins", "directions"), grads[:2], compact_grads[:2]):
        torch.testing.assert_close(mine, other, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(grads[2][mask], compact_grads[2], rtol=0, atol=0)
    assert (grads[2][~mask] == 0).all()


@pytest.mark.parametrize("softness", [60.0, 1000.0])
def test_pairs_whose_gates_overflow_add_exact_zeros(softness):
    """What the flat kernels' skip relies on: where ``gates_overflow`` holds, the fp32
    pair's sigma and each of its 22 cotangents are exactly 0, so leaving the pair
    after its geometry changes no sum. The skip must also be real: some pairs
    overflow and some do not."""
    inputs, gbar = _random_sigma_inputs(torch.float32)
    origins, directions, _, columns, _ = inputs
    table = columns.reshape(-1, kernels.NUM_COLUMNS)
    rays = kernels._rays(origins, directions)
    parameters = (softness, 0.05, 1e-12)
    skipped = kept = 0
    for b in range(table.shape[0]):
        column = table[b].expand(origins.shape[0], kernels.NUM_COLUMNS)
        sigma, pair = kernels._pair_terms(rays, column, None, *parameters)
        far = kernels.gates_overflow(pair, softness, parameters[1])
        ray_parts, column_parts = kernels._pair_cotangents(rays, column, 1.0, None, gbar, *parameters)
        assert (sigma[far] == 0).all()
        for part in ray_parts + column_parts:
            assert (part[far] == 0).all()
        skipped += int(far.sum())
        kept += int((~far).sum())
    assert skipped > 0 and kept > 0


def test_gate_constants_match_the_kernel_source():
    """The plain side's clamp and skip threshold are the kernels' own, and two
    denominators of at least e^GATE_OVERFLOW_EXPONENT overflow fp32."""
    source = (pathlib.Path(kernels.__file__).parent / "csrc" / "blocking.cu").read_text()
    assert f"kExpClamp = {kernels.EXP_CLAMP}f;" in source
    assert f"kOverflowExponent = {kernels.GATE_OVERFLOW_EXPONENT}f;" in source
    assert kernels.GATE_OVERFLOW_EXPONENT < kernels.EXP_CLAMP
    big = torch.exp(torch.tensor(kernels.GATE_OVERFLOW_EXPONENT, dtype=torch.float32))
    assert torch.isinf(big * big) and float(1.0 / (big * big)) == 0.0


def test_flat_operators_dispatch_and_check_their_inputs():
    """On the CPU the operators are the plain versions; malformed inputs raise."""
    inputs, gbar = _random_sigma_inputs(torch.float32)
    origins, directions, t_target, columns, _ = inputs
    table = columns.reshape(-1, kernels.NUM_COLUMNS).contiguous()
    keep = torch.ones(table.shape[0])
    parameters = (1000.0, 0.05, 1e-12)
    expected = kernels.sigma_flat_forward_plain(origins, directions, table, keep, *parameters)
    torch.testing.assert_close(kernels.blocking_sigma_flat(origins, directions, table, keep, *parameters), expected,
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        kernels.blocking_sigma_flat(origins, directions, table, keep[:-1], *parameters)
    with pytest.raises(ValueError):
        kernels.blocking_sigma_flat(origins, directions, columns, keep, *parameters)  # [M, K, 16]
    with pytest.raises(TypeError):
        kernels.blocking_sigma_flat(*(x.half() for x in (origins, directions, table, keep)), *parameters)
    own = torch.full((origins.shape[0],), -1)
    aabb = torch.cat([table[:, :3], table[:, :3] + 1.0], dim=1).contiguous()
    torch.testing.assert_close(
        kernels.blocking_cull(origins, directions, t_target, own, aabb),
        kernels.cull_plain(origins, directions, t_target, own, aabb), rtol=0, atol=0,
    )
    with pytest.raises(ValueError):
        kernels.blocking_cull(origins, directions, t_target, own.int(), aabb)
    with pytest.raises(ValueError):
        kernels.blocking_cull(origins, directions, t_target, own, aabb[:, :5].contiguous())
    with pytest.raises(ValueError):
        kernels.sigma_flat_forward_cuda(origins, directions, table, keep, *parameters)  # not CUDA tensors


@pytest.mark.parametrize("ray_chunk", [None, 2], ids=["whole", "chunk2"])
@pytest.mark.parametrize("method", ["pallas", "auto"])
def test_trace_rays_flat_matches_jax(dense_rows, ray_chunk, method):
    (jax_scenario, jax_points, jax_normals, jax_targets, jax_incident), port, du, de = dense_rows
    scenario, points, normals, targets, incident = port
    theirs = jax_render.trace_rays(
        jax_scenario.solar_tower, jax_points, jax_normals, jax_incident, jax_targets,
        jnp.asarray(du), jnp.asarray(de),
        blocking_primitives=jax_blocking.create_blocking_primitives_rectangles_by_index(jax_points),
        ray_primitive_indices=jnp.arange(HELIOSTATS),
        config=jax_render.RenderConfig(
            bitmap_resolution=BITMAP, ray_chunk=ray_chunk, blocking_active=True,
            blocking_method=method, blocking_candidates=None,
        ),
    )
    ours = render.trace_rays(
        scenario.solar_tower, points, normals, incident, targets, torch.tensor(du), torch.tensor(de),
        blocking_primitives=blocking.create_blocking_primitives_rectangles_by_index(points),
        ray_primitive_indices=torch.arange(HELIOSTATS),
        config=render.RenderConfig(
            bitmap_resolution=BITMAP, ray_chunk=ray_chunk, blocking_active=True, blocking_candidates=None
        ),
    )
    flux, flux_jax = ours[0].numpy(), np.asarray(theirs[0])
    assert flux.sum() > 0
    np.testing.assert_allclose(flux, flux_jax, rtol=0, atol=1e-4 * flux_jax.max())
    for mine, other in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(other), rtol=1e-6, atol=0)
    assert float(ours[3].min()) < 1.0  # some heliostat is blocked
    assert float(ours[3].max()) == 1.0  # the front row is not


def test_checkpointed_flat_chunks_save_sigma_and_keep(dense_rows, monkeypatch):
    """Launch counts chip_smoke.py asserts on the flat route: per chunk one cull and one
    flat sigma forward (their outputs are saved, so the recompute runs neither), one flat
    sigma backward, two splat forwards (the recompute reruns it) and one splat backward."""
    _, (scenario, points, normals, targets, incident), du, de = dense_rows
    splat_module = sys.modules["artist_tpu_torch.kernels.splat"]
    calls = dict.fromkeys(("cull", "sigma_forward", "sigma_backward", "splat_forward", "splat_backward"), 0)

    def counted(module, name, key):
        original = getattr(module, name)

        def wrapper(*args):
            calls[key] += 1
            return original(*args)

        monkeypatch.setattr(module, name, wrapper)

    counted(kernels, "cull_plain", "cull")
    counted(kernels, "sigma_flat_forward_plain", "sigma_forward")
    counted(kernels, "sigma_flat_backward_plain", "sigma_backward")
    counted(splat_module, "splat_forward_plain", "splat_forward")
    counted(splat_module, "splat_backward_plain", "splat_backward")
    leaf = points.detach().clone().requires_grad_(True)
    flux = render.trace_rays(
        scenario.solar_tower, leaf, normals.detach(), incident, targets, torch.tensor(du), torch.tensor(de),
        blocking_primitives=blocking.create_blocking_primitives_rectangles_by_index(leaf),
        ray_primitive_indices=torch.arange(HELIOSTATS),
        config=render.RenderConfig(
            bitmap_resolution=BITMAP, ray_chunk=1, blocking_active=True, blocking_candidates=None
        ),
    )[0]
    assert calls["sigma_forward"] == calls["cull"] == RAYS
    flux.square().sum().backward()
    assert calls == {
        "cull": RAYS, "sigma_forward": RAYS, "sigma_backward": RAYS, "splat_forward": 2 * RAYS, "splat_backward": RAYS,
    }
    assert float(leaf.grad.abs().max()) > 0


@pytest.mark.parametrize("candidates", [16, None], ids=["compacted", "flat"])
def test_primitive_chunk_changes_nothing(grazing, candidates):
    origins, directions, corners, spans, normals, t_target = grazing
    results = []
    for chunk in (None, 1):
        args = [torch.tensor(x, requires_grad=True) for x in (origins, directions, corners, spans, normals)]
        mask = blocking.soft_ray_blocking_mask(
            *args, intersection_distances_target=torch.tensor(t_target), ray_primitive_indices=torch.tensor([0, 1]),
            softness=6.0, primitive_chunk=chunk, max_candidates=candidates,
        )
        mask.square().sum().backward()
        results.append([mask.detach()] + [a.grad for a in args])
    assert float(results[0][0].max()) > 0.1
    for plain, chunked in zip(*results):
        torch.testing.assert_close(chunked, plain, rtol=0, atol=0)

"""The port's LBVH against the JAX package's and against the dense cull.

The same numpy inputs (``tests/raytracing/test_lbvh.py``'s random fields and
northward rays, loaded by path) go to both packages. Bit for bit: the Morton
bit spreading, the codes, the longest common prefix, the tree where the JAX
package's is well formed (8 primitives), and the keep-set, which must equal the
JAX package's dense cull ``_global_primitive_cull`` and the port's
``cull_primitives`` (both are hard decisions from the same fp32 slab test).
The JAX package's own tree is malformed from 64 primitives on (its split search
halves by floor, ``artist_tpu/raytracing/lbvh.py:185-191``); one test records
that fault, which ``ROADMAP.md`` queue 3 lists and the port does not copy. The
traversal runs its plain version here (the tensors lie on the CPU).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from artist_tpu.raytracing import lbvh as jax_lbvh
from artist_tpu.raytracing.blocking import _global_primitive_cull
from artist_tpu_torch.kernels import lbvh as kernels
from artist_tpu_torch.raytracing import blocking, lbvh

_spec = importlib.util.spec_from_file_location(
    "jax_lbvh_test_fields", pathlib.Path(__file__).resolve().parent / "raytracing" / "test_lbvh.py"
)
_fields = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fields)
TREE_FIELDS = ("left", "right", "is_leaf", "primitive_index", "aabb_min", "aabb_max")


def _scene(num: int):
    corners = _fields._random_field(num)
    origins, directions, t_target = _fields._rays_towards_north(corners, num)
    return corners, origins, directions, t_target, np.arange(num)


def test_expand_bits_matches_jax():
    values = np.concatenate([np.arange(0, 1024, 3), [1023, 1024, 2047, 123456]]).astype(np.int32)
    ours = lbvh.expand_bits(torch.tensor(values)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_lbvh.expand_bits(jnp.asarray(values))))


@pytest.mark.parametrize("num", [2, 5, 33, 300])
def test_morton_codes_match_jax(num):
    points = np.random.RandomState(num).uniform(-100, 100, (num, 3)).astype(np.float32)
    points[num // 2] = points[0]  # a duplicate centroid
    ours = lbvh.morton_codes(torch.tensor(points)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_lbvh.morton_codes(jnp.asarray(points))))


def test_longest_common_prefix_matches_jax():
    codes = np.sort(np.random.RandomState(1).randint(0, 1 << 30, 40)).astype(np.int32)
    codes[10:13] = codes[10]  # equal codes: the index breaks the tie
    i = np.repeat(np.arange(40), 5).astype(np.int32)
    j = (i + np.tile([-41, -1, 1, 7, 40], 40)).astype(np.int32)  # out of range on both sides too
    ours = lbvh.longest_common_prefix(torch.tensor(codes), torch.tensor(i).long(), torch.tensor(j).long()).numpy()
    theirs = np.asarray(jax_lbvh.longest_common_prefix(jnp.asarray(codes), jnp.asarray(i), jnp.asarray(j)))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("num", [2, 8, 64, 300])
def test_tree_is_well_formed(num):
    """A walk from the root reaches every leaf, and visits every node once; every child's
    box lies inside its parent's; a leaf's box is its primitive's."""
    corners = _fields._random_field(num)
    tree = lbvh.build_linear_bounding_volume_hierarchies(torch.tensor(corners))
    shape = chip_smoke.lbvh_tree_checks(tree)
    assert shape == dict(leaves_reached=num, leaves=num, most_visits=1, nested=True)
    leaves = tree.is_leaf.numpy()
    primitives = tree.primitive_index.numpy()[leaves]
    np.testing.assert_array_equal(np.sort(primitives), np.arange(num))
    np.testing.assert_array_equal(tree.aabb_min.numpy()[leaves], corners[primitives, :, :3].min(axis=1))
    np.testing.assert_array_equal(tree.aabb_max.numpy()[leaves], corners[primitives, :, :3].max(axis=1))


def test_tree_equals_jax_where_jax_is_well_formed():
    corners = _fields._random_field(8)
    ours = lbvh.build_linear_bounding_volume_hierarchies(torch.tensor(corners))
    theirs = jax_lbvh.build_linear_bounding_volume_hierarchies(jnp.asarray(corners))
    assert chip_smoke.lbvh_tree_checks(theirs)["leaves_reached"] == 8
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)), err_msg=name)


@pytest.mark.parametrize("num", [8, 64, 300])
def test_keep_set_equals_the_dense_culls(num):
    corners, origins, directions, t_target, own = _scene(num)
    dense = np.asarray(_global_primitive_cull(*(jnp.asarray(x) for x in (origins, directions, corners, t_target, own))))
    tensors = [torch.tensor(x) for x in (origins, directions, corners, own, t_target)]
    ours = lbvh.lbvh_filter_blocking_planes(*tensors).numpy()
    cull = blocking.cull_primitives(*tensors[:3], tensors[3], tensors[4]).numpy() > 0
    assert 0 < dense.sum() < num or num == 8
    np.testing.assert_array_equal(ours, dense)
    np.testing.assert_array_equal(ours, cull)


def test_jax_lbvh_fault_at_64_primitives():
    """The JAX package's tree over 64 primitives reaches 37 leaves, so its LBVH filter keeps
    29 where its dense cull keeps 51 (ROADMAP.md, queue 3); the port keeps the 51."""
    corners, origins, directions, t_target, own = _scene(64)
    tree = jax_lbvh.build_linear_bounding_volume_hierarchies(jnp.asarray(corners))
    shape = chip_smoke.lbvh_tree_checks(tree)
    assert (shape["leaves_reached"], shape["most_visits"]) == (37, 2)
    arrays = [jnp.asarray(x) for x in (origins, directions, corners, own, t_target)]
    assert int(np.asarray(jax_lbvh.lbvh_filter_blocking_planes(*arrays)).sum()) == 29
    dense = _global_primitive_cull(*(jnp.asarray(x) for x in (origins, directions, corners, t_target, own)))
    assert int(np.asarray(dense).sum()) == 51
    ours = lbvh.lbvh_filter_blocking_planes(*(torch.tensor(x) for x in (origins, directions, corners, own, t_target)))
    assert int(ours.sum()) == 51


def test_plain_traversal_drops_overflowing_pushes():
    """A stack too small for the tree drops pushes: the keep-set can only shrink, and the
    count of visits with it; the full stack keeps the dense cull's set."""
    corners, origins, directions, t_target, own = _scene(300)
    nodes = lbvh.lbvh_nodes(lbvh.build_linear_bounding_volume_hierarchies(torch.tensor(corners)))
    inputs = (
        torch.tensor(origins), torch.tensor(directions).reshape(300, -1, 4).contiguous(),
        torch.tensor(t_target).reshape(300, -1).contiguous(), torch.tensor(own),
    )
    full, visits = kernels.traverse_plain(*inputs, nodes, count_visits=True)
    small, small_visits = kernels.traverse_plain(*inputs, nodes, stack_size=3, count_visits=True)
    assert int(small.sum()) < int(full.sum()) and small_visits < visits
    assert bool((small <= full).all())
    chunked = kernels.traverse_plain(*inputs, nodes, ray_chunk=7)
    assert torch.equal(chunked, full)


def test_keep_flags_repeat_on_the_same_inputs():
    """The recompute of a checkpointed chunk rebuilds the tree and traverses again: the
    decisions are functions of the same inputs and come out the same."""
    corners, origins, directions, t_target, own = _scene(64)
    tensors = [torch.tensor(x) for x in (origins, directions, corners, own, t_target)]
    first = lbvh.lbvh_keep(*tensors)
    again = lbvh.lbvh_keep(*(x.clone() for x in tensors))
    assert torch.equal(first, again)


@pytest.mark.parametrize("max_candidates", [None, 16])
def test_lbvh_mask_equals_the_dense_flat_route(max_candidates):
    """``cull_method="lbvh"`` on the plant chunk's inputs at a small size (25 heliostats, rows 3 m
    apart, so that primitives are kept and rays blocked), with and without
    ``max_candidates`` (the LBVH always takes the flat route): the mask, and its
    gradient, equal the dense cull's flat route bit for bit."""
    inputs = chip_smoke.plant_chunk_inputs(torch.device("cpu"), chip_smoke.DENSE_ROW_SPACING, heliostats=25, chunk=25,
                                           surface_points=(3, 3), rays=2)
    corners, spans, normals = (x.detach() for x in inputs["primitives"])
    results = {}
    for method, candidates in (("dense", None), ("lbvh", max_candidates)):
        leaf = inputs["origins"].clone().requires_grad_(True)
        mask = blocking.soft_ray_blocking_mask(
            leaf, inputs["directions"], corners, spans, normals, intersection_distances_target=inputs["t_target"],
            ray_primitive_indices=inputs["own"], cull_method=method, max_candidates=candidates,
        )
        mask.sum().backward()
        results[method] = (mask.detach(), leaf.grad)
    assert float(results["dense"][0].max()) > 0.5  # some ray is blocked
    assert torch.equal(results["lbvh"][0], results["dense"][0])
    assert torch.equal(results["lbvh"][1], results["dense"][1])


def test_soft_ray_blocking_mask_refuses_an_unknown_cull_method():
    inputs = chip_smoke.plant_chunk_inputs(torch.device("cpu"), None, heliostats=4, chunk=2, surface_points=(2, 2),
                                           rays=1)
    with pytest.raises(ValueError, match="cull_method"):
        blocking.soft_ray_blocking_mask(
            inputs["origins"], inputs["directions"], *inputs["primitives"],
            intersection_distances_target=inputs["t_target"], cull_method="bvh",
        )


def test_lbvh_filter_refuses_another_stack_size():
    corners, origins, directions, t_target, own = _scene(8)
    with pytest.raises(ValueError, match="stack"):
        lbvh.lbvh_filter_blocking_planes(
            *(torch.tensor(x) for x in (origins, directions, corners, own, t_target)), stack_size=32
        )


def test_leading_zeros_match_jax():
    values = np.concatenate([
        [0, 1, 2, 3, 4, 7, 8, 2**24 - 1, 2**24 + 1, 2**30 - 1, 2**30, 2**31 - 1],
        np.random.RandomState(2).randint(0, 2**31 - 1, 1000),
    ]).astype(np.int32)
    ours = lbvh._leading_zeros32(torch.tensor(values)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_lbvh._leading_zeros32(jnp.asarray(values))))


def test_ray_aabb_intersect_matches_jax():
    rng = np.random.RandomState(4)
    origins = rng.uniform(-5, 5, (7, 1, 3)).astype(np.float32)
    inverse = (1.0 / rng.uniform(-1, 1, (7, 1, 3))).astype(np.float32)
    low = rng.uniform(-3, 0, (1, 5, 3)).astype(np.float32)
    high = low + rng.uniform(0.5, 2, (1, 5, 3)).astype(np.float32)
    ours = lbvh.ray_aabb_intersect(*(torch.tensor(x) for x in (origins, inverse, low, high)))
    theirs = jax_lbvh.ray_aabb_intersect(*(jnp.asarray(x) for x in (origins, inverse, low, high)))
    for mine, other in zip(ours, theirs):
        assert mine.shape == (7, 5)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(other))

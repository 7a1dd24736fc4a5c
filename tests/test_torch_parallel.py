"""The port's ``parallel/`` pieces against the JAX package's, in one process.

The round-robin map and its inverse, ``split_into_groups`` and the result
merge equal the JAX package's exactly (integer and copy work). The mesh, the
process group and the collectives run in a world of one (gloo on the CPU);
``put_global``'s rule runs on a stand-in mesh of 2 x 3 ranks, since a world of
one splits nothing. ``Rays`` and ``rotate_distortions`` (the small remainder of
``scene/`` and ``geometry/``) close the file: the rotations equal JAX's and
``apply_distortion_rotation``'s to 1e-6 (fp32 trigonometry and products).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artist_tpu.geometry.transforms import rotate_distortions as jax_rotate_distortions
from artist_tpu.parallel import collectives as jax_collectives
from artist_tpu.parallel.env import _invert_mapping as jax_invert_mapping
from artist_tpu.parallel.mesh import distribute_groups_among_ranks as jax_distribute
from artist_tpu.scenario.synthetic import make_synthetic_scenario as jax_synthetic
from artist_tpu.scenario.synthetic import split_into_groups as jax_split_into_groups
from artist_tpu.scene.rays import Rays as JaxRays
from artist_tpu_torch.convert import scenario_from_numpy
from artist_tpu_torch.geometry.transforms import apply_distortion_rotation, rotate_distortions
from artist_tpu_torch.parallel import (
    DistributedSetup,
    collectives,
    distribute_groups_among_ranks,
    make_mesh,
    put_global,
    ray_sharding,
    replicated_sharding,
    sample_sharding,
    setup_distributed_environment,
)
from artist_tpu_torch.parallel.env import _invert_mapping
from artist_tpu_torch.parallel.mesh import ShardPlan, fetch_global, local_slice, shard_count
from artist_tpu_torch.scenario.synthetic import split_into_groups
from artist_tpu_torch.scene.rays import Rays

PAIRS = [(1, 3), (2, 4), (3, 2), (8, 3), (4, 4), (2, 1), (5, 2), (1, 1)]


@pytest.mark.parametrize("world_size, groups", PAIRS)
def test_round_robin_mapping_and_its_inverse_match_jax(world_size, groups):
    mine = distribute_groups_among_ranks(groups, world_size)
    assert mine == jax_distribute(groups, world_size)
    assert _invert_mapping(mine) == jax_invert_mapping(mine)
    # Every group has a rank, and nested worlds give each rank exactly one group.
    assert sorted({g for gs in mine.values() for g in gs}) == list(range(groups))
    if world_size > groups:
        assert all(len(gs) == 1 for gs in mine.values())


def test_setup_distributed_environment_single_process():
    import torch.distributed as dist

    with setup_distributed_environment(number_of_heliostat_groups=2, device="cpu") as setup:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert not setup.is_distributed and not setup.is_nested
        assert (setup.rank, setup.world_size) == (0, 1)
        assert setup.groups_to_ranks_mapping == {0: [0, 1]}
        assert setup.ranks_to_groups_mapping == {0: [0], 1: [0]}
        assert setup.mesh.mesh_dim_names == ("heliostats", "rays") and tuple(setup.mesh.shape) == (1, 1)
    assert not dist.is_initialized()


def test_make_mesh_shapes_and_refusals():
    with setup_distributed_environment(1, device="cpu") as setup:
        mesh = make_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("heliostats", "rays")
        assert tuple(make_mesh((1, 1), "cpu").shape) == (1, 1)
        for shape in ((3, 5), (2, 1), (1, 2), (1, 1, 1)):
            with pytest.raises(ValueError, match="does not match"):
                make_mesh(shape, "cpu")
        assert mesh.get_group("heliostats") is not None and setup.mesh.size() == 1


def test_a_world_needs_an_address_and_a_failed_bootstrap_raises():
    """No fall-back to one process (the JAX package logs and goes on): two processes
    without an address refuse to start, and a rank whose coordinator never answers
    fails within its timeout."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="coordinator_address"):
        with setup_distributed_environment(1, num_processes=2, process_id=0, device="cpu"):
            pass
    with pytest.raises(Exception):
        with setup_distributed_environment(
            1, coordinator_address="127.0.0.1:1", num_processes=2, process_id=1, device="cpu", timeout=2.0
        ):
            pass
    assert not dist.is_initialized()


def test_collectives_in_one_process_are_identities():
    obj = {"a": np.arange(3)}
    assert collectives.all_gather_object(obj) == [obj]
    assert collectives.broadcast_object(obj, 0) is obj
    np.testing.assert_array_equal(collectives.all_reduce_min([1.0, 2.0]), [1.0, 2.0])
    np.testing.assert_array_equal(collectives.all_reduce_sum([1.0, 2.0]), [1.0, 2.0])
    collectives.barrier()
    assert (collectives.world_size(), collectives.rank()) == (1, 0)
    x = torch.ones(3, requires_grad=True)
    for op in (collectives.sum_for_replicated, collectives.gather_for_replicated, collectives.gather_for_shards):
        assert op(x, None) is x
    assert collectives.copy_to_shards(x, (None,)) is x


class FakeMesh:
    """A stand-in ``DeviceMesh`` of ``shape`` ranks, seen from the rank at ``coordinate``."""

    mesh_dim_names = ("heliostats", "rays")

    def __init__(self, shape, coordinate):
        self.shape, self.coordinate = shape, coordinate

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]

    def get_local_rank(self, dim):
        return self.coordinate[self.mesh_dim_names.index(dim)]


PUT_CASES = {
    # (global shape, sharding, expected slices) on a 2 x 3 mesh, at coordinate (1, 2).
    "both_split": ((4, 6, 5), "ray", (slice(2, 4), slice(4, 6))),
    "samples_replicated": ((3, 6, 5), "ray", (slice(0, 3), slice(4, 6))),
    "rays_replicated": ((4, 5, 5), "ray", (slice(2, 4), slice(0, 5))),
    "samples": ((6, 2), "sample", (slice(3, 6),)),
    "samples_odd": ((5, 2), "sample", (slice(0, 5),)),
    "replicated": ((4, 6), "replicated", ()),
}


@pytest.mark.parametrize("case", sorted(PUT_CASES))
def test_put_global_splits_what_divides_and_replicates_the_rest(case):
    shape, kind, expected = PUT_CASES[case]
    mesh = FakeMesh((2, 3), (1, 2))
    sharding = {"ray": ray_sharding, "sample": sample_sharding, "replicated": replicated_sharding}[kind](mesh)
    tensor = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    local = put_global(tensor, sharding)
    torch.testing.assert_close(local, tensor[expected], rtol=0, atol=0)
    if local is not tensor:
        assert local.data_ptr() != tensor.data_ptr()  # a copy: the global tensor can go


def test_put_and_fetch_global_at_world_one():
    with setup_distributed_environment(1, device="cpu") as setup:
        tensor = torch.arange(24.0).reshape(2, 3, 4)
        for sharding in (sample_sharding(setup.mesh), ray_sharding(setup.mesh), replicated_sharding(setup.mesh)):
            assert put_global(tensor, sharding) is tensor
            assert fetch_global(tensor, sharding, tuple(tensor.shape)) is tensor
        plan = ShardPlan(setup.mesh, 2, 3)
        assert plan.sample_group is None and plan.ray_group is None
        assert plan.sample_slice == slice(0, 2) and plan.ray_slice == slice(0, 3)
        assert plan.take(tensor) is tensor and plan.params(tensor) is tensor and plan.flux(tensor) is tensor
    assert shard_count(None, "rays", 7) == 1 and local_slice(None, "rays", 7) == slice(0, 7)


def _scenes(heliostats: int = 4):
    jax_scenario = jax_synthetic(
        number_of_heliostats=heliostats, number_of_control_points_per_facet=(4, 4),
        number_of_surface_points_per_facet=(3, 3), number_of_rays=2,
    )

    def as_dict(x):
        return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}

    scenario = scenario_from_numpy(
        jax_scenario.power_plant_position, as_dict(jax_scenario.solar_tower),
        [as_dict(sun) for sun in jax_scenario.light_sources],
        [as_dict(group) for group in jax_scenario.heliostat_groups],
        jax_scenario.heliostat_group_names, device="cpu",
    )
    return jax_scenario, scenario


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_split_into_groups_matches_jax(groups):
    jax_scenario, scenario = _scenes()
    theirs, ours = jax_split_into_groups(jax_scenario, groups), split_into_groups(scenario, groups)
    assert ours.heliostat_group_names == theirs.heliostat_group_names
    assert len(ours.heliostat_groups) == len(theirs.heliostat_groups) == groups
    for mine, other in zip(ours.heliostat_groups, theirs.heliostat_groups):
        assert mine.names == tuple(other.names) and mine.number_of_heliostats == 4 // groups
        for field in dataclasses.fields(mine):
            value = getattr(mine, field.name)
            if isinstance(value, torch.Tensor):
                np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(other, field.name)), err_msg=field.name)
    assert ours.solar_tower is scenario.solar_tower and ours.light_sources is scenario.light_sources


def test_split_into_groups_refuses_what_jax_refuses():
    jax_scenario, scenario = _scenes(heliostats=6)
    for split in (split_into_groups, jax_split_into_groups):
        with pytest.raises(ValueError, match="split evenly"):
            split(scenario if split is split_into_groups else jax_scenario, 4)
    with pytest.raises(ValueError, match="single-group"):
        split_into_groups(split_into_groups(scenario, 2), 2)


@dataclasses.dataclass
class _Result:
    group_index: int
    payload: str


def _setup(world_size: int, groups_to_ranks, ranks_to_groups, nested: bool = False) -> DistributedSetup:
    return DistributedSetup(world_size > 1, nested, 0, world_size, groups_to_ranks, ranks_to_groups)


GATHERED = [
    (np.array([0.5, np.inf, 3.0]), [_Result(0, "rank0-g0"), _Result(1, "rank0-g1-stale")],
     {0: "cp0-rank0", 1: "cp1-stale"}),
    (np.array([np.inf, 2.0, 4.0]), [_Result(1, "rank1-g1")], {1: "cp1-owner"}),
]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_merge_prefers_owning_rank_and_min_reduces(monkeypatch, package):
    """A faked two-rank gather (``tests/parallel/test_collectives.py:43``): rank 1 owns
    group 1, so its payload wins though rank 0's copy comes first; the loss reduces
    to the elementwise minimum; both packages merge alike."""
    module = collectives if package == "port" else jax_collectives
    monkeypatch.setattr(module, "all_gather_object", lambda obj, tag="": GATHERED)
    setup = _setup(2, {0: [0], 1: [1]}, {0: [0], 1: [1]})
    arguments = (setup, GATHERED[0][0], GATHERED[0][1], GATHERED[0][2])
    # The JAX package names each key-value exchange with a tag; the process group needs none.
    arguments += ("t",) if package == "jax" else ()
    final_loss, results, payloads = module.synchronize_group_results(*arguments)
    np.testing.assert_array_equal(final_loss, [0.5, 2.0, 3.0])
    assert [r.group_index for r in results] == [0, 1]
    assert results[1].payload == "rank1-g1"
    assert payloads == {0: "cp0-rank0", 1: "cp1-owner"}


def test_merge_in_one_process_is_the_identity():
    final_loss, results, payloads = np.array([1.0, 2.0]), [_Result(0, "a")], {0: "cp"}
    for setup in (None, _setup(1, {0: [0]}, {0: [0]})):
        merged = collectives.synchronize_group_results(setup, final_loss, results, payloads)
        assert merged[0] is final_loss and merged[1] is results and merged[2] is payloads
    assert collectives.merge_group_outputs(None, {0: 1}) == {0: 1}


def test_merge_group_outputs_orders_the_ranks_groups(monkeypatch):
    monkeypatch.setattr(collectives, "all_gather_object", lambda obj: [{2: "b", 0: "a"}, {1: "c"}])
    merged = collectives.merge_group_outputs(_setup(2, {0: [0, 2], 1: [1]}, {0: [0], 1: [1], 2: [0]}), {})
    assert list(merged.items()) == [(0, "a"), (1, "c"), (2, "b")]
    nested = _setup(2, {0: [0], 1: [0]}, {0: [0, 1]}, nested=True)
    assert collectives.merge_group_outputs(nested, {0: "x"}) == {0: "x"}


# --------------------------------------------------------------------------- #
# scene/rays.py and geometry/transforms.py rotate_distortions.
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shapes", [((2, 3, 5, 4), (2, 3, 5)), ((1, 1, 1, 4), (1, 1, 1))])
def test_rays_accept_consistent_shapes(shapes):
    directions, magnitudes = torch.zeros(shapes[0]), torch.ones(shapes[1])
    rays = Rays(directions, magnitudes)
    assert rays.ray_directions is directions and rays.ray_magnitudes is magnitudes
    JaxRays(jnp.zeros(shapes[0]), jnp.ones(shapes[1]))


@pytest.mark.parametrize("shapes", [((2, 3, 5, 4), (2, 3, 4)), ((2, 3, 5, 4), (2, 3, 5, 4))])
def test_rays_refuse_inconsistent_shapes_as_jax_does(shapes):
    with pytest.raises(ValueError, match="inconsistent"):
        Rays(torch.zeros(shapes[0]), torch.ones(shapes[1]))
    with pytest.raises(ValueError, match="inconsistent"):
        JaxRays(jnp.zeros(shapes[0]), jnp.ones(shapes[1]))


def _angles(shape=(3, 5, 7)):
    rng = np.random.RandomState(7)
    return rng.normal(0.0, 0.3, shape).astype(np.float32), rng.normal(0.0, 0.3, shape).astype(np.float32)


def test_rotate_distortions_matches_jax():
    e, u = _angles()
    ours = rotate_distortions(torch.tensor(e), torch.tensor(u))
    assert ours.shape == e.shape + (4, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_rotate_distortions(jnp.asarray(e), jnp.asarray(u))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("components", [3, 4])
def test_rotate_distortions_equals_apply_distortion_rotation(components):
    """The matrices applied to directions (w = 0) equal the fused rotation, and are rotations."""
    e, u = _angles()
    rng = np.random.RandomState(11)
    directions = rng.normal(size=e.shape + (4,)).astype(np.float32)
    directions[..., 3] = 0.0
    directions = torch.tensor(directions[..., :components])
    matrices = rotate_distortions(torch.tensor(e), torch.tensor(u))
    padded = torch.nn.functional.pad(directions, (0, 4 - components))
    applied = (matrices @ padded[..., None])[..., 0][..., :components]
    fused = apply_distortion_rotation(torch.tensor(e), torch.tensor(u), directions)
    torch.testing.assert_close(applied, fused, rtol=0, atol=1e-6)
    identity = matrices @ matrices.transpose(-1, -2)
    torch.testing.assert_close(identity, torch.eye(4).expand_as(identity), rtol=0, atol=1e-6)

"""Process meshes and the slices of tensors they shard.

Counterpart of ``artist_tpu/parallel/mesh.py`` on ``torch.distributed``. The
JAX package's 2-D device mesh with axes ``("heliostats", "rays")`` becomes a
:class:`torch.distributed.device_mesh.DeviceMesh` over the world's ranks with
the same dims, one process (and one device) a rank:

- the sample axis of every per-sample tensor is split over ``heliostats``;
- the ray axis of the sun-distortion tensors ``[M, R, P]`` over ``rays``;
- parameters stay whole on every rank.

JAX places a sharded array and lets XLA insert the sums; here
:func:`put_global` hands each rank its slice, and the optimizers sum and
gather explicitly (:mod:`~artist_tpu_torch.parallel.collectives`).
:func:`distribute_groups_among_ranks` is the round-robin map of heliostat
groups to ranks of the group-parallel mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from artist_tpu_torch.parallel import collectives

MESH_DIMS = ("heliostats", "rays")


def make_mesh(shape: tuple[int, int] | None = None, device_type: str = "cuda"):
    """A 2-D ``DeviceMesh`` over every rank of the initialised default process group,
    with dims :data:`MESH_DIMS`.

    Parameters
    ----------
    shape : tuple[int, int] | None
        (heliostat shards, ray shards); default ``(world, 1)``, all ranks on the
        ``heliostats`` dim.
    device_type : str
        The ranks' device type (``"cuda"`` or ``"cpu"``).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(n) for n in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not match {world} ranks")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=MESH_DIMS)


@dataclass(frozen=True)
class Sharding:
    """Which mesh dim splits each leading axis of a tensor (None: the axis stays whole)."""

    mesh: object
    dims: tuple[str | None, ...]


def sample_sharding(mesh) -> Sharding:
    """Per-sample tensors: the leading axis over ``heliostats``."""
    return Sharding(mesh, (MESH_DIMS[0],))


def ray_sharding(mesh) -> Sharding:
    """Distortion tensors ``[M, R, P]``: M over ``heliostats``, R over ``rays``."""
    return Sharding(mesh, MESH_DIMS)


def replicated_sharding(mesh) -> Sharding:
    """Whole on every rank (parameters, small scene state)."""
    return Sharding(mesh, ())


def shard_count(mesh, dim: str | None, length: int) -> int:
    """The shards an axis of ``length`` takes on mesh dim ``dim``: the dim's size where it
    divides ``length``, else 1 (the axis is replicated, as the JAX package's
    ``put_global`` replicates rather than fail)."""
    if mesh is None or dim is None:
        return 1
    count = mesh.size(mesh.mesh_dim_names.index(dim))
    return count if length % count == 0 else 1


def local_slice(mesh, dim: str | None, length: int) -> slice:
    """This rank's part of an axis of ``length`` split over ``dim`` (:func:`shard_count`)."""
    count = shard_count(mesh, dim, length)
    if count == 1:
        return slice(0, length)
    size = length // count
    index = mesh.get_local_rank(dim)
    return slice(index * size, (index + 1) * size)


def put_global(array: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's slice of the global tensor ``array`` under ``sharding``.

    Every rank holds the same global tensor (data loading is deterministic and
    replicated); each keeps its part along every axis ``sharding`` splits. An axis
    whose length its dim's size does not divide stays whole (small calibration
    batches on a wide mesh): the computation stays right, unsplit along it. The
    slice is a copy, so the global tensor can be freed.
    """
    index = tuple(local_slice(sharding.mesh, dim, array.shape[axis]) for axis, dim in enumerate(sharding.dims))
    if all(part == slice(0, array.shape[axis]) for axis, part in enumerate(index)):
        return array
    return array[index].clone()


def fetch_global(tensor: torch.Tensor, sharding: Sharding, shape: tuple[int, ...]) -> torch.Tensor:
    """The global tensor of ``shape`` from each rank's :func:`put_global` slice of it,
    all-gathered along every axis that ``sharding`` split (not differentiable)."""
    for axis, dim in enumerate(sharding.dims):
        if shard_count(sharding.mesh, dim, shape[axis]) > 1:
            tensor = collectives.all_gather_tensor(tensor, sharding.mesh.get_group(dim), axis)
    return tensor


def distribute_groups_among_ranks(number_of_heliostat_groups: int, world_size: int) -> dict[int, list[int]]:
    """Round-robin map of heliostat groups to ranks: ``rank -> [group indices]``.

    With more ranks than groups (the nested mode) rank ``r`` takes group
    ``r % groups``: every group is run by several ranks, which split its samples.
    """
    mapping: dict[int, list[int]] = {rank: [] for rank in range(world_size)}
    if world_size <= number_of_heliostat_groups:
        for group_index in range(number_of_heliostat_groups):
            mapping[group_index % world_size].append(group_index)
    else:
        for rank in range(world_size):
            mapping[rank].append(rank % number_of_heliostat_groups)
    return mapping


@dataclass(frozen=True)
class ShardPlan:
    """How one batch of ``samples`` samples (or heliostats) with ``rays`` rays a point
    splits over ``mesh``: its samples over ``heliostats``, its rays over ``rays``,
    each where the dim's size divides it (:func:`shard_count`); no mesh splits
    nothing.

    A step reads its parameters through :meth:`params`, slices its per-sample
    tensors with :meth:`take` and its distortions with :meth:`distortions`, and
    turns its partial results into the global ones every rank then holds alike:
    :meth:`flux` sums a ray slice's maps, :meth:`per_sample` gathers per-sample
    values, :meth:`factors` combines per-heliostat ray shares. With nothing split,
    each is the identity and launches no collective.
    """

    mesh: object | None
    samples: int
    rays: int = 1

    def _group(self, dim: str, length: int):
        return self.mesh.get_group(dim) if shard_count(self.mesh, dim, length) > 1 else None

    @property
    def sample_group(self):
        return self._group(MESH_DIMS[0], self.samples)

    @property
    def ray_group(self):
        return self._group(MESH_DIMS[1], self.rays)

    @property
    def sample_slice(self) -> slice:
        return local_slice(self.mesh, MESH_DIMS[0], self.samples)

    @property
    def ray_slice(self) -> slice:
        return local_slice(self.mesh, MESH_DIMS[1], self.rays)

    def take(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's samples of a per-sample tensor (leading axis ``samples``)."""
        return put_global(tensor, Sharding(self.mesh, (MESH_DIMS[0],)))

    def distortions(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's samples and rays of a distortion tensor ``[samples, rays, P]``."""
        return put_global(tensor, Sharding(self.mesh, MESH_DIMS))

    def params(self, tensor: torch.Tensor) -> torch.Tensor:
        """A whole parameter as the split work reads it (its gradient summed over the ranks)."""
        return collectives.copy_to_shards(tensor, (self.sample_group, self.ray_group))

    def flux(self, tensor: torch.Tensor) -> torch.Tensor:
        """Per-sample maps of this rank's rays summed over the ray slices."""
        return collectives.sum_for_replicated(tensor, self.ray_group)

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """A map summed over every rank's samples and rays (the field's flux)."""
        return collectives.sum_for_replicated(self.flux(tensor), self.sample_group)

    def per_sample(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every sample's value from each rank's samples (differentiable)."""
        return collectives.gather_for_replicated(tensor, self.sample_group)

    def factors(self, tensor: torch.Tensor, points: int) -> torch.Tensor:
        """A per-sample share of rays (``trace_rays``'s intercept, on-target and
        blocking factors, counts over ``rays * points``) over every sample and every
        ray: the ray slices' counts summed and divided by all rays, as one process
        divides them."""
        group = self.ray_group
        if group is not None:
            local_rays = self.ray_slice.stop - self.ray_slice.start
            counts = torch.round(tensor.double() * (local_rays * points)).to(torch.int64)
            tensor = collectives.all_reduce_tensor(counts, group) / (self.rays * points)
        if self.sample_group is not None:
            tensor = collectives.all_gather_blocks(tensor, self.sample_group)
        return tensor

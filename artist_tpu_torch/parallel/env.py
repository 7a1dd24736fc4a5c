"""Multi-process setup on ``torch.distributed``.

Counterpart of ``artist_tpu/parallel/env.py``. :func:`setup_distributed_environment`
starts the process group (and ends it), and yields a :class:`DistributedSetup`
with the JAX package's fields, its ``mesh`` a
:class:`~torch.distributed.device_mesh.DeviceMesh` over every rank
(:func:`~artist_tpu_torch.parallel.mesh.make_mesh`). Two modes follow from the
world size and the number of heliostat groups:

- group-parallel (world <= groups): each rank runs its round-robin groups
  alone, and the optimizers merge the results afterwards (each once a run, the
  aim-point optimizer once an epoch);
- nested (world > groups): every rank runs every group, the samples split over
  the mesh's ``heliostats`` dim and the rays over its ``rays`` dim.

A bootstrap that fails raises: there is no fall-back to one process.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from dataclasses import dataclass, field

import torch

from artist_tpu_torch.parallel.mesh import distribute_groups_among_ranks, make_mesh

log = logging.getLogger("artist_tpu_torch.parallel")

DEFAULT_TIMEOUT_SECONDS = 600.0


@dataclass
class DistributedSetup:
    """The run's ranks: this one's, the world's and the group-to-rank maps.

    ``groups_to_ranks_mapping`` is ``rank -> [groups]`` (as the JAX package names
    it), ``ranks_to_groups_mapping`` ``group -> [ranks]``.
    """

    is_distributed: bool
    is_nested: bool
    rank: int
    world_size: int
    groups_to_ranks_mapping: dict[int, list[int]]
    ranks_to_groups_mapping: dict[int, list[int]] = field(default_factory=dict)
    mesh: object | None = None


def is_group_parallel(setup: DistributedSetup | None) -> bool:
    """Whether ``setup`` runs the group-parallel mode: more than one rank, and no more
    ranks than groups, so each rank runs its own groups alone."""
    return setup is not None and setup.is_distributed and not setup.is_nested


def runs_group(setup: DistributedSetup | None, group_index: int) -> bool:
    """Whether this rank runs group ``group_index``: every group, but in the
    group-parallel mode only its round-robin ones."""
    if not is_group_parallel(setup):
        return True
    return group_index in setup.groups_to_ranks_mapping.get(setup.rank, [])


def resolve_mesh(mesh, setup: DistributedSetup | None):
    """The mesh an optimizer splits each group over: ``mesh``, or the setup's own in
    the nested mode. A mesh splits a group over ranks that all run it, so the
    group-parallel mode, where each rank runs its groups alone, refuses one."""
    if mesh is not None and is_group_parallel(setup):
        raise ValueError("a mesh splits each group over ranks that all run it: not in the group-parallel mode")
    if mesh is None and setup is not None and setup.is_nested:
        return setup.mesh
    return mesh


def _invert_mapping(groups_to_ranks: dict[int, list[int]]) -> dict[int, list[int]]:
    """``rank -> [groups]`` to ``group -> [ranks]``."""
    inverted: dict[int, list[int]] = {}
    for rank, groups in groups_to_ranks.items():
        for group in groups:
            inverted.setdefault(group, []).append(rank)
    return inverted


@contextlib.contextmanager
def setup_distributed_environment(
    number_of_heliostat_groups: int,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    mesh_shape: tuple[int, int] | None = None,
    device: str = "cuda",
    backend: str | None = None,
    timeout: float = DEFAULT_TIMEOUT_SECONDS,
):
    """Start the process group, yield the run's :class:`DistributedSetup`, end the group.

    Parameters
    ----------
    number_of_heliostat_groups : int
        Groups of the scenario, which the ranks share out.
    coordinator_address : str | None
        ``host:port`` of rank 0's store. None: the ``torchrun`` environment
        (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) where it is set; a single
        process otherwise, which needs no address.
    num_processes, process_id : int | None
        World size and this process's rank (from the environment when None).
    mesh_shape : tuple[int, int] | None
        (heliostat shards, ray shards); default ``(world, 1)``.
    device : str
        ``"cuda"`` (each rank on card ``rank % device_count``, or ``LOCAL_RANK``) or
        ``"cpu"``.
    backend : str | None
        ``"nccl"`` or ``"gloo"``; default NCCL on the card, gloo on the CPU. NCCL
        refuses two ranks on one card: such ranks use gloo.
    timeout : float
        Seconds a collective may wait for the other ranks before it fails.

    A process group that already exists (one the caller started) is used and left
    running.
    """
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of PyTorch")
    device_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    started_here = False
    if not dist.is_initialized():
        environment = coordinator_address is None and "MASTER_ADDR" in os.environ
        world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
        if device_type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        arguments = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout), world_size=world, rank=rank)
        if coordinator_address is not None:
            dist.init_process_group(init_method=f"tcp://{coordinator_address}", **arguments)
        elif environment:
            dist.init_process_group(init_method="env://", **arguments)
        elif world == 1:
            dist.init_process_group(store=dist.HashStore(), **arguments)
        else:
            raise ValueError(
                f"a world of {world} processes needs a coordinator_address or the torchrun environment"
            )
        started_here = True
    try:
        rank = dist.get_rank()
        world_size = dist.get_world_size()
        groups_to_ranks = distribute_groups_among_ranks(number_of_heliostat_groups, world_size)
        setup = DistributedSetup(
            is_distributed=world_size > 1,
            is_nested=world_size > number_of_heliostat_groups,
            rank=rank,
            world_size=world_size,
            groups_to_ranks_mapping=groups_to_ranks,
            ranks_to_groups_mapping=_invert_mapping(groups_to_ranks),
            mesh=make_mesh(mesh_shape, device_type),
        )
        if rank == 0:
            log.info(
                "Distributed environment: %d process(es) on %s, %d heliostat group(s), nested=%s, mesh=%s.",
                world_size, dist.get_backend(), number_of_heliostat_groups, setup.is_nested,
                tuple(setup.mesh.shape),
            )
        yield setup
    finally:
        if started_here:
            dist.destroy_process_group()

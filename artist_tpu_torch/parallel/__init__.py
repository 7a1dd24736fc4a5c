"""Processes, their meshes and collectives, and heliostat-axis microbatching.

Counterpart of ``artist_tpu/parallel``: :mod:`~artist_tpu_torch.parallel.env`
(the process group and :class:`DistributedSetup`),
:mod:`~artist_tpu_torch.parallel.mesh` (the ``("heliostats", "rays")`` mesh and
the slices it shards), :mod:`~artist_tpu_torch.parallel.collectives` (result
merges and differentiable exchanges) and
:mod:`~artist_tpu_torch.parallel.microbatch`.
"""

from artist_tpu_torch.parallel import collectives, microbatch
from artist_tpu_torch.parallel.env import DistributedSetup, setup_distributed_environment
from artist_tpu_torch.parallel.mesh import (
    distribute_groups_among_ranks,
    make_mesh,
    put_global,
    ray_sharding,
    replicated_sharding,
    sample_sharding,
)
from artist_tpu_torch.parallel.microbatch import chunked_map, chunked_sum, chunked_sum_and_map

__all__ = [
    "DistributedSetup",
    "collectives",
    "setup_distributed_environment",
    "distribute_groups_among_ranks",
    "make_mesh",
    "put_global",
    "sample_sharding",
    "ray_sharding",
    "replicated_sharding",
    "microbatch",
    "chunked_map",
    "chunked_sum",
    "chunked_sum_and_map",
]

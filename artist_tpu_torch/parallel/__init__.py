"""Heliostat-axis microbatching (:mod:`~artist_tpu_torch.parallel.microbatch`).

The JAX package's ``env``, ``collectives`` and ``mesh`` (processes, device
meshes and their collectives) are not ported yet.
"""

from artist_tpu_torch.parallel import microbatch
from artist_tpu_torch.parallel.microbatch import chunked_map, chunked_sum, chunked_sum_and_map

__all__ = ["chunked_map", "chunked_sum", "chunked_sum_and_map", "microbatch"]

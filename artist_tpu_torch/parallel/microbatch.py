"""Sample-axis microbatching: gradient accumulation over checkpointed chunks.

Counterpart of ``artist_tpu/parallel/microbatch.py``. A plant-scale field
(4,000 heliostats) would keep its O(heliostats x surface points)
intermediates (gathered states, aligned points and normals, the trace's
per-ray tensors) field-wide for the backward. Cutting the leading
(heliostat) axis into chunks, each run under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, keeps one
chunk's: the backward recomputes each chunk's forward, and the parameters'
gradients accumulate over the chunks as autograd sums them. Losses that
reduce per sample split exactly: ``mean = chunked_sum(sum of a chunk) / N``.

The JAX package scans the chunks with ``lax.scan``; here a Python loop runs
them one after the other. A pytree is a nested tuple, list or dict of
tensors (``torch.utils._pytree``). ``fn`` must draw no random numbers: the
recompute does not restore the random state. Tensors that ``fn`` closes
over (the parameters) receive their gradients as if they were arguments.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint


def _chunks(xs: Any, chunk: int) -> list[Any]:
    """``xs`` cut along its leaves' leading axis into pytrees of ``chunk`` rows each."""
    leaves, spec = pytree.tree_flatten(xs)
    for leaf in leaves:
        if leaf.shape[0] % chunk:
            raise ValueError(f"leading axis {leaf.shape[0]} is not divisible by chunk {chunk}")
    count = leaves[0].shape[0] // chunk if leaves else 0
    return [
        pytree.tree_unflatten([leaf[i * chunk : (i + 1) * chunk] for leaf in leaves], spec)
        for i in range(count)
    ]


def _run(fn: Callable[[Any], Any], x: Any, remat: bool) -> Any:
    if remat:
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
    return fn(x)


def _concatenate(parts: list[Any]) -> Any:
    return pytree.tree_map(lambda *ys: torch.cat(ys), *parts)


def _add(total: Any, part: Any) -> Any:
    return pytree.tree_map(torch.add, total, part)


def chunked_map(fn: Callable[[Any], Any], xs: Any, chunk: int, remat: bool = True) -> Any:
    """Apply ``fn`` to leading-axis chunks of ``xs``; concatenate the outputs.

    ``fn`` maps a chunk of ``xs`` to a pytree whose leaves have the chunk on
    their leading axis. With ``remat`` (the default) each chunk's forward is
    recomputed in the backward, so autograd keeps one chunk's intermediates
    at a time besides the (small) outputs.
    """
    return _concatenate([_run(fn, x, remat) for x in _chunks(xs, chunk)])


def chunked_sum(fn: Callable[[Any], Any], xs: Any, chunk: int, remat: bool = True) -> Any:
    """The sum of ``fn`` over leading-axis chunks of ``xs`` (gradient accumulation)."""
    total = None
    for x in _chunks(xs, chunk):
        part = _run(fn, x, remat)
        total = part if total is None else _add(total, part)
    return total


def chunked_sum_and_map(
    fn: Callable[[Any], tuple[Any, Any]], xs: Any, chunk: int, remat: bool = True
) -> tuple[Any, Any]:
    """One pass returning both a sum and concatenated outputs.

    ``fn`` maps a chunk to ``(sum_part, map_part)``: the first is summed over
    the chunks (the field's total flux), the second stitched back along the
    leading axis (per-heliostat factors), so a loss that needs both runs each
    chunk's forward once.
    """
    total, parts = None, []
    for x in _chunks(xs, chunk):
        sum_part, map_part = _run(fn, x, remat)
        total = sum_part if total is None else _add(total, sum_part)
        parts.append(map_part)
    return total, _concatenate(parts)

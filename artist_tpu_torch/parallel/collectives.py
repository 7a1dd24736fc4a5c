"""Collectives across the ranks of a run: result merges and differentiable exchanges.

Counterpart of ``artist_tpu/parallel/collectives.py`` on ``torch.distributed``.
The JAX package exchanges small host objects through its coordination
service's key-value store and leaves every in-step sum to XLA; here both ride
the process group:

- host merges, once a reconstruction or once an epoch: :func:`all_gather_object`,
  :func:`broadcast_object`, :func:`all_reduce_min`, :func:`all_reduce_sum`,
  :func:`barrier` and :func:`synchronize_group_results` (the owning rank's result
  wins, losses reduce by their minimum, results are ordered by group);
- exchanges inside a differentiable step, each an autograd function whose
  backward is the one the global function needs. Every rank holds the
  parameters whole and computes the replicated part of the loss (the part after
  the exchange) identically, so a collective's backward must not sum the
  replicated cotangents again:

  - :func:`copy_to_shards`: forward the identity, backward the sum over the ranks
    that split the work. A parameter enters the split part of a step through it,
    so its gradient is the sum of every rank's share (the DDP all-reduce);
  - :func:`sum_for_replicated`: forward the sum of every rank's partial (a flux
    map of a ray slice), backward the identity;
  - :func:`gather_for_replicated`: forward the ranks' slices concatenated (per
    sample losses), backward this rank's slice of the cotangent;
  - :func:`gather_for_shards`: forward the ranks' blocks concatenated (blocking
    primitives every rank's trace reads), backward the sum over the ranks of the
    whole cotangent, then this rank's block.

A backend that cannot carry a tensor's device gets the tensor through host
memory: gloo carries CUDA tensors only in ``all_reduce`` and ``broadcast``, so
its gathers of CUDA tensors copy to the CPU and back. Every rank must call the
collectives in the same order; a rank that is missing turns into an error after
the process group's timeout.

``STATISTICS`` counts the calls that reach the process group and the host
seconds spent in them (waiting for the other ranks included; under NCCL, which
returns once the work is queued, the host time only), since
:func:`reset_statistics`. Reading the clock costs well under a microsecond a call.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import numpy as np
import torch

# The collectives that gloo runs on CUDA tensors.
_GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})
STATISTICS = {"calls": 0, "seconds": 0.0}


def reset_statistics() -> None:
    STATISTICS.update(calls=0, seconds=0.0)


@contextlib.contextmanager
def _timed():
    start = time.perf_counter()
    try:
        yield
    finally:
        STATISTICS["calls"] += 1
        STATISTICS["seconds"] += time.perf_counter() - start


def _dist():
    import torch.distributed as dist

    return dist


def is_multiprocess() -> bool:
    """True when a process group of more than one rank is initialised."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _through_host(tensor: torch.Tensor, op: str, group=None) -> bool:
    """Whether ``op`` on ``tensor`` must go through host memory on ``group``'s backend."""
    return tensor.is_cuda and _dist().get_backend(group) == "gloo" and op not in _GLOO_CUDA_OPS


def _object_device(group=None) -> torch.device:
    """Where a host value travels for a collective: the current card under NCCL, else the CPU."""
    if _dist().get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _group_size(group) -> int:
    return _dist().get_world_size(group)


def _group_rank(group) -> int:
    return _dist().get_rank(group)


# --------------------------------------------------------------------------- #
# Host merges.
# --------------------------------------------------------------------------- #


def all_gather_object(obj: Any) -> list[Any]:
    """One picklable object from each rank, ordered by rank (``[obj]`` in one process).
    The process group orders the exchanges, so none needs the JAX package's key tag."""
    if not is_multiprocess():
        return [obj]
    gathered: list[Any] = [None] * _dist().get_world_size()
    with _timed():
        _dist().all_gather_object(gathered, obj)
    return gathered


def broadcast_object(obj: Any, source_rank: int) -> Any:
    """``source_rank``'s object on every rank."""
    if not is_multiprocess():
        return obj
    holder = [obj if _dist().get_rank() == source_rank else None]
    with _timed():
        _dist().broadcast_object_list(holder, src=source_rank)
    return holder[0]


def _all_reduce_host(values, op) -> np.ndarray:
    array = np.asarray(values)
    if not is_multiprocess():
        return array
    tensor = torch.as_tensor(array).to(_object_device())
    with _timed():
        _dist().all_reduce(tensor, op=op)
    return tensor.cpu().numpy()


def all_reduce_min(values) -> np.ndarray:
    """Elementwise minimum over the ranks (host numpy in and out)."""
    return _all_reduce_host(values, _dist().ReduceOp.MIN)


def all_reduce_sum(values) -> np.ndarray:
    """Elementwise sum over the ranks (host numpy in and out; not differentiable)."""
    return _all_reduce_host(values, _dist().ReduceOp.SUM)


def barrier() -> None:
    """Wait until every rank gets here."""
    if not is_multiprocess():
        return
    with _timed():
        if _dist().get_backend() == "nccl":
            _dist().barrier(device_ids=[torch.cuda.current_device()])
        else:
            _dist().barrier()


def synchronize_group_results(distributed_setup, final_loss: np.ndarray, results: list,
                              group_payloads: dict[int, Any]):
    """Merge the per-group outcomes of the ranks of a group-parallel run.

    Each group's payload (its optimized parameters) and result record come from
    the first rank that owns the group; the per-heliostat losses over the whole
    field (``inf`` where a rank did not run a heliostat) reduce to their minimum;
    the results are ordered by group index. ``None`` or a one-rank setup returns
    the inputs unchanged.

    Returns
    -------
    tuple
        ``(final_loss, results, group_payloads)`` over every rank.
    """
    if distributed_setup is None or not distributed_setup.is_distributed:
        return final_loss, results, group_payloads
    gathered = all_gather_object((final_loss, results, group_payloads))
    merged_loss = np.minimum.reduce([rank_data[0] for rank_data in gathered])

    def owner_of(group_index: int) -> int:
        owners = distributed_setup.ranks_to_groups_mapping.get(group_index)
        return owners[0] if owners else 0

    merged_results: dict[int, Any] = {}
    merged_payloads: dict[int, Any] = {}
    for source_rank, (_, rank_results, rank_payloads) in enumerate(gathered):
        for result in rank_results:
            if source_rank == owner_of(result.group_index):
                merged_results[result.group_index] = result
            else:
                merged_results.setdefault(result.group_index, result)
        for group_index, payload in rank_payloads.items():
            if source_rank == owner_of(group_index):
                merged_payloads[group_index] = payload
            else:
                merged_payloads.setdefault(group_index, payload)
    ordered = [merged_results[index] for index in sorted(merged_results)]
    return merged_loss, ordered, merged_payloads


def merge_group_outputs(distributed_setup, outputs: dict[int, Any]) -> dict[int, Any]:
    """``{group_index: output}`` of every rank of a group-parallel run, ordered by
    group (each group has one owner there); the input itself otherwise."""
    if distributed_setup is None or not distributed_setup.is_distributed or distributed_setup.is_nested:
        return outputs
    merged: dict[int, Any] = {}
    for rank_outputs in all_gather_object(outputs):
        merged.update(rank_outputs)
    return dict(sorted(merged.items()))


def world_group():
    """The default process group (all ranks)."""
    return _dist().group.WORLD


def world_size() -> int:
    """Ranks of the initialised process group; 1 without one."""
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# --------------------------------------------------------------------------- #
# Tensor collectives (not differentiable).
# --------------------------------------------------------------------------- #


def all_reduce_tensor(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks, as a new tensor."""
    out = tensor.detach().clone().contiguous()
    if _group_size(group) > 1:
        if out.is_cuda and _dist().get_backend(group) == "gloo":
            # gloo waits for the card before it reduces a CUDA tensor: wait here, so that
            # STATISTICS counts the exchange and not the card's queue.
            torch.cuda.current_stream(out.device).synchronize()
        with _timed():
            _dist().all_reduce(out, op=_dist().ReduceOp.SUM, group=group)
    return out


def all_gather_blocks(tensor: torch.Tensor, group=None, sizes: list[int] | None = None) -> torch.Tensor:
    """Every rank's block of ``group`` concatenated along dim 0, in rank order.

    ``sizes`` gives each rank's leading length where they differ (all equal to this
    rank's by default)."""
    count = _group_size(group)
    if count == 1:
        return tensor
    if sizes is None:
        sizes = [tensor.shape[0]] * count
    if tensor.shape[0] != sizes[_group_rank(group)]:
        raise ValueError(f"block of {tensor.shape[0]} rows, expected {sizes[_group_rank(group)]}")
    longest = max(sizes)
    host = _through_host(tensor, "all_gather", group)
    carrier = tensor.detach().cpu() if host else tensor.detach()
    if tensor.shape[0] < longest:
        pad = carrier.new_zeros((longest - tensor.shape[0],) + tuple(tensor.shape[1:]))
        carrier = torch.cat([carrier, pad])
    carrier = carrier.contiguous()
    parts = [torch.empty_like(carrier) for _ in range(count)]
    with _timed():
        _dist().all_gather(parts, carrier, group=group)
    out = torch.cat([part[:size] for part, size in zip(parts, sizes)])
    return out.to(tensor.device) if host else out


def all_gather_tensor(tensor: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's equally shaped ``tensor`` of ``group`` concatenated along ``dim``."""
    moved = tensor.movedim(dim, 0)
    return all_gather_blocks(moved, group).movedim(0, dim)


# --------------------------------------------------------------------------- #
# Differentiable exchanges.
# --------------------------------------------------------------------------- #


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, groups):
        ctx.groups = groups
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        for group in ctx.groups:
            grad = all_reduce_tensor(grad, group)
        return grad, None


class _SumForReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        return all_reduce_tensor(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherForReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.rows = tensor.shape[0]
        ctx.rank = _group_rank(group)
        return all_gather_blocks(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.rows
        return grad[start : start + ctx.rows], None


class _GatherForShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, sizes):
        ctx.group = group
        ctx.start = sum(sizes[: _group_rank(group)])
        ctx.rows = tensor.shape[0]
        return all_gather_blocks(tensor, group, sizes)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_tensor(grad, ctx.group)
        return total[ctx.start : ctx.start + ctx.rows], None, None


def _live(groups) -> tuple:
    return tuple(group for group in groups if group is not None and _group_size(group) > 1)


def copy_to_shards(tensor: torch.Tensor, groups) -> torch.Tensor:
    """``tensor`` as it enters the split part of a step: the identity, whose backward
    sums the gradient over each process group of ``groups`` (the ranks that split
    the work; None or one-rank groups are skipped)."""
    groups = _live(groups)
    return _CopyToShards.apply(tensor, groups) if groups else tensor


def sum_for_replicated(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``group``'s partial tensors, consumed alike by every rank: the
    backward hands each partial the replicated cotangent unchanged."""
    if not _live((group,)):
        return tensor
    return _SumForReplicated.apply(tensor, group)


def gather_for_replicated(tensor: torch.Tensor, group) -> torch.Tensor:
    """``group``'s equal slices concatenated along dim 0, in rank order, consumed
    alike by every rank: the backward keeps this rank's slice of the cotangent."""
    if not _live((group,)):
        return tensor
    return _GatherForReplicated.apply(tensor, group)


def gather_for_shards(tensor: torch.Tensor, group, sizes: list[int] | None = None) -> torch.Tensor:
    """``group``'s blocks (of leading lengths ``sizes``, all equal by default)
    concatenated along dim 0, each rank's consumer its own: the backward sums the
    whole cotangent over the ranks and keeps this rank's block."""
    if not _live((group,)):
        return tensor
    if sizes is None:
        sizes = [tensor.shape[0]] * _group_size(group)
    return _GatherForShards.apply(tensor, group, list(sizes))

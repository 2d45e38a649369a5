"""Collectives that autograd sees: the Megatron pair and the gathers of
multi-rank training (the JAX package gets them from XLA's SPMD partitioner).

  * ``copy_to_group`` (Megatron's "f"): identity forward, sum of the
    gradient over the group backward. It sits at the input of every
    column-parallel projection (q/k/v, gate/up, the vocab-parallel lm_head):
    each rank's projection sees only its columns, so each rank's gradient of
    the shared input is a partial sum.
  * ``reduce_from_group`` (Megatron's "g"): sum forward, identity backward,
    after the row-parallel wo and down.
  * ``gather_last_dim``: the ranks' last-dim shards concatenated in rank
    order forward, this rank's slice of the gradient backward (the
    vocab-parallel logits, from which every rank computes the same loss).
  * ``gather_batch``: the ranks' rows concatenated in rank order forward;
    backward, the gradient summed over the group and this rank's rows kept
    (the reference's ``GatherLayer``, for losses whose negatives come from
    other ranks).

Every sum reduces f32 partials and rounds once to the input's dtype (gloo
takes no bf16; for two ranks the rounded f32 sum is bitwise the bf16 one).
Over gloo a gather goes through the host. ``group=None`` makes each of them
the identity. Each function counts the collectives it issues on its
``calls`` attribute, forward and backward, recomputation included.

The four stay correct under ``torch.utils.checkpoint(use_reentrant=False)``:
the recomputed forward issues its collectives again, in the same order on
every rank, since every rank runs the same graph.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(x: torch.Tensor, group, counted) -> torch.Tensor:
    """x summed over ``group`` as f32 partials, rounded once to x's dtype."""
    acc = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(acc, group=group)
    counted.calls += 1
    return acc.to(x.dtype)


def _gather(x: torch.Tensor, group, dim: int, counted=None) -> torch.Tensor:
    """The ranks' tensors concatenated on ``dim`` in rank order; one more
    on ``counted.calls``, if given."""
    dev = x.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    mine = x.to(dev).contiguous()
    if mine.dtype == torch.bfloat16 and dev.type == "cpu":
        mine = mine.float()
    parts = [torch.empty_like(mine) for _ in range(_size(group))]
    dist.all_gather(parts, mine, group=group)
    if counted is not None:
        counted.calls += 1
    return torch.cat(parts, dim=dim).to(device=x.device, dtype=x.dtype)


def _local(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal share of ``x`` on ``dim``."""
    n = _size(group)
    per = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * per, per).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group, copy_to_group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group, reduce_from_group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group, -1, gather_last_dim)

    @staticmethod
    def backward(ctx, dy):
        return _local(dy, ctx.group, -1), None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group, 0, gather_batch)

    @staticmethod
    def backward(ctx, dy):
        return _local(_sum(dy, ctx.group, gather_batch), ctx.group, 0), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """f: identity forward, the gradient summed over ``group`` backward."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """g: ``x`` summed over ``group`` forward, identity backward."""
    return x if group is None else _Reduce.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """(..., n_local) -> (..., n_local * ranks) in rank order; backward, this
    rank's slice of the gradient."""
    return x if group is None or _size(group) == 1 else _GatherLast.apply(x, group)


def gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """(b_local, ...) -> (b_local * ranks, ...) in rank order; backward, the
    gradient summed over ``group``, this rank's rows. Integer tensors are
    gathered without a gradient."""
    if group is None or _size(group) == 1:
        return x
    if not x.is_floating_point():
        return _gather(x, group, 0, gather_batch)
    return _GatherBatch.apply(x, group)


def sum_over(tree_leaves, group) -> list:
    """The tensors of ``tree_leaves`` each summed over ``group`` (no
    gradient), in one all-reduce of their f32 concatenation; each is
    rounded once to its own dtype. The identity for None."""
    if group is None or not tree_leaves:
        return list(tree_leaves)
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in tree_leaves])
    dist.all_reduce(flat, group=group)
    sum_over.calls += 1
    out, at = [], 0
    for x in tree_leaves:
        out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
        at += x.numel()
    return out


for _fn in (copy_to_group, reduce_from_group, gather_last_dim, gather_batch, sum_over):
    _fn.calls = 0

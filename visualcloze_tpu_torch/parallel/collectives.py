"""Differentiable collectives over a process group, the port's explicit
counterparts of what GSPMD inserts behind JAX's back.

Megatron's pair for tensor parallelism: `copy_to` is the identity forward
and sums the gradient over the group backward (a replicated tensor entering
rank-local work: a column-parallel linear's input, a replicated factor used
on a shard); `reduce_from` sums rank-partial results forward and passes the
gradient through backward (a row-parallel linear's output). `gather_cat`
concatenates every rank's block along a dim; its backward either takes the
rank's own block of a gradient that every rank holds whole ("slice": the
DiT's output gathered from its cp sequence blocks, whose loss every cp rank
computes alike) or sums the gradients first ("sum", a reduce-scatter: the
pipeline's input, which each rank feeds from its own batch share). A group of None, or of one rank, makes
each of them the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if group_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along dim, in group-rank order (no autograd)."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal block of x along dim."""
    n = group_size(group)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, backward):
        ctx.group, ctx.dim, ctx.sum = group, dim, backward == "sum"
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum:
            g = all_reduce_(g.contiguous().clone(), ctx.group)
        return own_block(g, ctx.group, ctx.dim), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1 or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    if not torch.is_grad_enabled():
        return all_reduce_(x.contiguous().clone(), group)
    return _ReduceFrom.apply(x, group)


def gather_cat(x: torch.Tensor, group, dim: int, backward: str = "sum") -> torch.Tensor:
    if backward not in ("sum", "slice"):
        raise ValueError(f"unknown gather_cat backward {backward!r}")
    if group_size(group) == 1:
        return x
    if not torch.is_grad_enabled():
        return all_gather_cat(x, group, dim)
    return _GatherCat.apply(x, group, dim, backward)

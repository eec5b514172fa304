"""The collectives of the scale-out path, over ``torch.distributed`` groups.

GSPMD gives the JAX package single-device semantics for free: it inserts
the gradient psum, the global BatchNorm reduction and the Megatron
all-reduce pair itself.  Here each one is an explicit call on the groups
of a ``DeviceMesh`` (parallel/mesh.py):

- ``all_reduce_sum``: a sum over one or more groups that autograd
  differentiates (its backward is the same sum of the gradients), for
  statistics that every rank's loss reads (BatchNorm's Σx and Σx²);
- ``copy_to_group`` / ``reduce_from_group``: Megatron's f and g, the
  identity forward with an all-reduce backward before a column-parallel
  layer, and the all-reduce forward with the identity backward after a
  row-parallel one;
- ``all_gather_rows``: the ranks' row blocks in rank order (evaluation,
  prediction, serving), no gradient.

A sum over several groups (the data axes 'dcn' and 'dp') reduces over each
in turn.  With no group (a world of one) every function is the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _sum_(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum: d(sum_r L_r)/dx_q is the sum over
        # the ranks of dL_r/d(sum); the trainer then averages the parameter
        # gradients over the same ranks
        return _sum_(grad.contiguous().clone(), ctx.groups), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.contiguous().clone(), (ctx.group,)), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_(x.contiguous().clone(), (group,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``groups``, differentiable."""
    groups = tuple(g for g in groups if g is not None)
    return _AllReduceSum.apply(x, groups) if groups else x


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: x as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: x summed over ``group``; its gradient as it is."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_gather_rows(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The row blocks of every rank of ``groups``, concatenated along dim 0
    in rank order (the first group innermost).  No gradient."""
    x = x.contiguous()
    for g in groups:
        if g is None:
            continue
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        x = torch.cat(parts)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` over ``group``, joined in rank
    order: the full tensor of a tensor-parallel shard."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)

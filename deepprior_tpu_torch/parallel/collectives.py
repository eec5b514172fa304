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
  prediction, serving), no gradient;
- ``halo_exchange`` / ``gather_rows_sp``: the 'sp' axis (parallel/spatial.py),
  a layer's input rows from the neighbouring ranks' blocks of the crop
  height and the trunk's last map whole on every sp rank, both
  differentiable.  Both move their rows with one all-reduce of a buffer in
  which each rank fills its own slot (``_gather_slots``): gloo and NCCL
  both take an all-reduce of CUDA tensors, where gloo's send/recv and
  all_gather do not, so the one route serves every backend; each slot has
  one writer, so the sum is exact.

A sum over several groups (the data axes 'dcn' and 'dp') reduces over each
in turn.  With no group (a world of one) every function is the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


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


def _rank_and_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def stack_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) over the ranks of
    ``groups``, stacked (the first group innermost), differentiable: one
    all-reduce of a buffer in which this rank fills its own slot."""
    groups = tuple(g for g in groups if g is not None)
    slot, size = 0, 1
    for g in groups:
        rank, n = _rank_and_size(g)
        slot, size = slot + rank * size, size * n
    return all_reduce_sum(torch.cat([x.new_zeros((slot,) + x.shape), x[None],
                                     x.new_zeros((size - slot - 1,) + x.shape)]), groups)


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
        if g is None or dist.get_world_size(g) == 1:
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


# ------------------------------------------------------------------ the 'sp' axis
def _gather_slots(x: torch.Tensor, context) -> torch.Tensor:
    """Every sp rank's ``x`` (one shape on every rank), stacked in rank
    order: one all-reduce of a (size, ...) buffer in which this rank fills
    its own slot."""
    buf = x.new_zeros((context.size,) + tuple(x.shape))
    buf[context.rank] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=context.group)
    return buf


def _rows(x, start, stop):
    return x[..., start:stop, :]


def _pad_rows(x, top, bottom):
    return F.pad(x, (0, 0, top, bottom)) if top or bottom else x


def _band(lo, hi) -> int:
    """The rows one rank sends a neighbour, at most: the widest halo that
    crosses two ranks."""
    return max(0, *lo[1:], *hi[:-1])


def _edges(x, band):
    """(first ``band`` rows, zeros after them if x is shorter; last ``band``
    rows, zeros before them if shorter), stacked."""
    n = x.shape[-2]
    k = min(band, n)
    return torch.stack([_pad_rows(_rows(x, 0, k), 0, band - k),
                        _pad_rows(_rows(x, n - k, n), band - k, 0)])


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, context):
        ctx.lo, ctx.hi, ctx.context = lo, hi, context
        r, last, n = context.rank, context.size - 1, x.shape[-2]
        band = _band(lo, hi)
        slots = _gather_slots(_edges(x, band), context) if band else None
        parts = []
        if lo[r] > 0:
            parts.append(x.new_zeros(x.shape[:-2] + (lo[r], x.shape[-1])) if r == 0
                         else _rows(slots[r - 1, 1], band - lo[r], band))
        parts.append(_rows(x, max(0, -lo[r]), n - max(0, -hi[r])))
        if hi[r] > 0:
            parts.append(x.new_zeros(x.shape[:-2] + (hi[r], x.shape[-1])) if r == last
                         else _rows(slots[r + 1, 0], 0, hi[r]))
        return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0].contiguous()

    @staticmethod
    def backward(ctx, g):
        lo, hi, context = ctx.lo, ctx.hi, ctx.context
        r, last, m = context.rank, context.size - 1, g.shape[-2]
        top, bottom = max(lo[r], 0), max(hi[r], 0)
        # this rank's own rows (a dropped row's gradient is 0)
        gx = _pad_rows(_rows(g, top, m - bottom), max(0, -lo[r]), max(0, -hi[r])).clone()
        band = _band(lo, hi)
        if band:
            # the halo rows' gradients go back to the ranks that own them:
            # the rows above to the rank above (its last rows, so aligned to
            # the band's end), the rows below to the rank below
            up = _rows(g, 0, top) if r > 0 else _rows(g, 0, 0)
            down = _rows(g, m - bottom, m) if r < last else _rows(g, m, m)
            slots = _gather_slots(torch.stack([
                _pad_rows(up, band - up.shape[-2], 0),
                _pad_rows(down, 0, band - down.shape[-2])]), context)
            n = gx.shape[-2]
            if r < last and lo[r + 1] > 0:
                gx[..., n - lo[r + 1]:, :] += _rows(slots[r + 1, 0], band - lo[r + 1], band)
            if r > 0 and hi[r - 1] > 0:
                gx[..., :hi[r - 1], :] += _rows(slots[r - 1, 1], 0, hi[r - 1])
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, lo, hi, context) -> torch.Tensor:
    """This sp rank's block of rows (dim -2) of ``x`` extended to the rows
    its layer reads: ``lo[r]`` / ``hi[r]`` rows (for every rank r of
    ``context``, a ``spatial.SpatialContext``) from the end of the rank
    above's block / the start of the rank below's, zeros past the first and
    last ranks' outer edges; a negative count drops that many of the rank's
    own rows instead.  The backward hands each halo row's gradient back to
    the rank that owns the row and adds it to that row's."""
    return _HaloExchange.apply(x, tuple(lo), tuple(hi), context)


class _GatherRowsSp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes, context):
        ctx.start = sum(sizes[:context.rank])
        ctx.n = sizes[context.rank]
        longest = max(sizes)
        slots = _gather_slots(_pad_rows(x, 0, longest - x.shape[-2]), context)
        return torch.cat([_rows(slots[q], 0, sizes[q]) for q in range(context.size)], dim=-2)

    @staticmethod
    def backward(ctx, g):
        # every sp rank computes the same loss from the gathered map: the
        # gradient of this rank's block is its rows of g, with no sum
        return _rows(g, ctx.start, ctx.start + ctx.n).contiguous(), None, None


def gather_rows_sp(x: torch.Tensor, sizes, context) -> torch.Tensor:
    """Every sp rank's block of rows (dim -2; ``sizes`` rows each, in rank
    order) concatenated, on every rank of ``context``."""
    return _GatherRowsSp.apply(x, tuple(sizes), context)

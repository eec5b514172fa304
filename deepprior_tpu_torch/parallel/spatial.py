"""The 'sp' axis: the crop height split over ranks, with a halo exchange
around every convolution that reads rows another rank owns.

GSPMD gives the JAX package this for free: it shards the crops' H axis
over 'sp' (deepprior_tpu/parallel/train_dist.py) and inserts the halo
exchanges around the convs and pools itself.  There is no JAX module to
mirror; this one writes down what GSPMD does implicitly.

Every sp rank of one data-parallel index holds the same rows of the batch
and the whole crop (K5 warps it at full height), and computes one block of
rows of every activation of the conv trunk.  The layout says, for each
conv (with its pool) of a trunk, which output rows each rank owns and
which input rows it needs:

- blocks are chosen on the pool outputs, so that no pool window straddles
  two ranks: a conv-pool chain (PoseRegNet, the ScaleNet towers) splits
  each layer's pooled rows evenly over the ranks; ResNet splits its final
  map and doubles the blocks back through each stride-2 stage and the
  stem's pool, so that every block starts at an even row;
- a rank's input rows are the previous layer's output block; the rows it
  needs beyond them come from its neighbours (``collectives.halo_exchange``),
  and at the crop's edges they are zeros (SAME padding) or absent (VALID);
  rows it holds but does not need are dropped;
- the first layer reads its rows from the whole crop, so it needs no
  exchange; the trunk's last map is gathered on every rank
  (``collectives.gather_rows_sp``) before the flatten and the head, which
  every sp rank runs whole.

A block that would be empty raises, naming the layer and the sizes.

``attach(model, context)`` gives a model its ``Plan``: the per-layer row
functions its forward runs before each conv (models/*.py read
``model.spatial``; None, the default, is the plain forward).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

Rows = Tuple[int, int]  # [start, stop)


class SpatialContext(NamedTuple):
    """The sp group a trunk runs under: its process group, this rank's
    index in it and its size."""

    group: Any
    rank: int
    size: int


class Layer(NamedTuple):
    """One conv (with its pool) of a trunk, on every sp rank.

    out:    the output rows each rank owns (after the pool)
    need:   the input rows each rank's output rows read (may reach past the
            input's edges: those rows are zeros)
    own_in: the input rows each rank holds, or None where every rank holds
            the whole input (the trunk's first layer)"""

    name: str
    h_in: int
    h_out: int
    out: Tuple[Rows, ...]
    need: Tuple[Rows, ...]
    own_in: Any = None

    @property
    def lo(self) -> Tuple[int, ...]:
        """Rows each rank takes above its block (< 0: rows it drops)."""
        return tuple(o[0] - n[0] for o, n in zip(self.own_in, self.need))

    @property
    def hi(self) -> Tuple[int, ...]:
        """Rows each rank takes below its block (< 0: rows it drops)."""
        return tuple(n[1] - o[1] for o, n in zip(self.own_in, self.need))

    def halo_rows(self, rank: int) -> int:
        """Rows ``rank`` receives from its neighbours (edge zeros excluded)."""
        if self.own_in is None:
            return 0
        last = len(self.out) - 1
        return ((max(self.lo[rank], 0) if rank > 0 else 0)
                + (max(self.hi[rank], 0) if rank < last else 0))


def split_rows(n: int, size: int) -> Tuple[Rows, ...]:
    """``n`` rows in ``size`` contiguous blocks, the first n % size one row
    longer."""
    base, extra = divmod(n, size)
    blocks, start = [], 0
    for r in range(size):
        stop = start + base + (1 if r < extra else 0)
        blocks.append((start, stop))
        start = stop
    return tuple(blocks)


def _input_rows(out: Rows, kernel: int, stride: int = 1, pad: int = 0,
                pool: int = 1) -> Rows:
    """The input rows a conv (kernel, stride, pad) followed by a floor pool
    of window and stride ``pool`` reads for the pooled rows ``out``."""
    c0, c1 = out[0] * pool, out[1] * pool
    return c0 * stride - pad, (c1 - 1) * stride - pad + kernel


def _layer(name, h_in, h_out, out, need, own_in) -> Layer:
    """A checked ``Layer``: every block non-empty, the zero rows only at the
    input's edges, and each rank's halo held by its direct neighbours."""
    size = len(out)
    for r, (a, b) in enumerate(out):
        if b <= a:
            raise ValueError(
                f"{name}: {h_out} output rows do not split over {size} sp ranks "
                f"(rank {r} would hold none)")
    for r, (a, b) in enumerate(need):
        if (a < 0 and r > 0) or (b > h_in and r < size - 1):
            raise ValueError(f"{name}: rank {r} needs rows [{a}, {b}) past the "
                             f"input's {h_in} rows away from its edge")
    layer = Layer(name, h_in, h_out, tuple(out), tuple(need),
                  None if own_in is None else tuple(own_in))
    if own_in is not None:
        sizes = [b - a for a, b in own_in]
        for r in range(size):
            if r > 0 and layer.lo[r] > sizes[r - 1]:
                raise ValueError(f"{name}: rank {r} needs {layer.lo[r]} rows from rank "
                                 f"{r - 1}, which holds {sizes[r - 1]}")
            if r < size - 1 and layer.hi[r] > sizes[r + 1]:
                raise ValueError(f"{name}: rank {r} needs {layer.hi[r]} rows from rank "
                                 f"{r + 1}, which holds {sizes[r + 1]}")
    return layer


def chain_layout(h: int, convs: Sequence[Tuple[int, int]], size: int,
                 name: str = "layer") -> List[Layer]:
    """The layout of a chain of VALID conv -> floor pool layers, given as
    (kernel, pool), over ``size`` sp ranks for an ``h``-row input: each
    layer's pooled rows split evenly (``split_rows``)."""
    layers, own_in = [], None
    for i, (k, p) in enumerate(convs):
        h_out = (h - k + 1) // p
        out = split_rows(h_out, size)
        need = [_input_rows(o, k, pool=p) for o in out]
        layers.append(_layer(f"{name} {i} ({h} rows, conv {k}, pool {p})", h, h_out, out,
                             need, own_in))
        h, own_in = h_out, out
    return layers


def resnet_layout(h: int, strides: Sequence[int], size: int) -> List[Layer]:
    """ResNet's layout for an ``h``-row input: the stem (5x5, SAME) with
    its 2x2 pool, then each bottleneck's 3x3 convolution, one bottleneck
    per stride in ``strides`` (1, or 2 for a projection that halves the
    map).  The final map's rows split evenly; each stride-2 block's input
    rows are its output rows doubled, and so are the stem's pooled rows, so
    that every block starts at an even row and a strided 1x1 convolution
    reads only rows its rank holds.  Only the 3x3 convolutions (SAME: one
    row each way) exchange rows."""
    sides = [h // 2]
    for s in strides:
        sides.append(sides[-1] // s)
    blocks_out = [split_rows(sides[-1], size)]
    for s, side in zip(reversed(strides), reversed(sides[:-1])):
        prev = blocks_out[0]
        # the last rank keeps the input's rows to its end (an odd side's
        # last row, which no strided read takes)
        blocks_out.insert(0, tuple((a * s, side if r == size - 1 else b * s)
                                   for r, (a, b) in enumerate(prev)))
    stem_out = blocks_out[0]
    layers = [_layer(f"stem ({h} rows, conv 5, pool 2)", h, sides[0], stem_out,
                     [_input_rows(o, 5, pad=2, pool=2) for o in stem_out], None)]
    for i, (rows, side) in enumerate(zip(blocks_out[1:], sides[1:])):
        layers.append(_layer(f"block {i} 3x3 ({side} rows)", side, side, rows,
                             [_input_rows(o, 3, pad=1) for o in rows], rows))
    return layers


# ------------------------------------------------------------- row functions
class TakeRows(NamedTuple):
    """A first layer's rows read from the whole input: rows [start, stop)
    of the H axis (dim -2), zeros past its edges."""

    start: int
    stop: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[-2]
        top, bottom = max(0, -self.start), max(0, self.stop - h)
        x = x[..., max(self.start, 0):min(self.stop, h), :]
        return F.pad(x, (0, 0, top, bottom)) if top or bottom else x


class Exchange(NamedTuple):
    """A layer's input rows from this rank's block and its neighbours'
    (``collectives.halo_exchange``)."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    context: SpatialContext

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from deepprior_tpu_torch.parallel.collectives import halo_exchange

        return halo_exchange(x, self.lo, self.hi, self.context)


class Gather(NamedTuple):
    """The trunk's last map whole on every rank
    (``collectives.gather_rows_sp``)."""

    sizes: Tuple[int, ...]
    context: SpatialContext

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from deepprior_tpu_torch.parallel.collectives import gather_rows_sp

        return gather_rows_sp(x, self.sizes, self.context)


def rows_fn(layer: Layer, context: SpatialContext) -> Callable:
    """What this rank runs on a layer's input before the conv."""
    if layer.own_in is None:
        return TakeRows(*layer.need[context.rank])
    return Exchange(layer.lo, layer.hi, context)


class Plan(NamedTuple):
    """A model's partitioned forward on one sp rank, one entry per trunk
    (ScaleNet's three towers; one for PoseRegNet and ResNet).

    rows:   per trunk, the function each conv's input goes through (ResNet:
            the stem's, then each bottleneck's 3x3)
    gather: per trunk, the gather of its last map
    layers: per trunk, the ``Layer`` of each of those convs"""

    rows: Any
    gather: Any
    layers: Any
    context: SpatialContext


def plan_for(model, context: SpatialContext) -> Plan:
    """The plan of a PoseRegNet, ResNet or ScaleNet at its input size."""
    from deepprior_tpu_torch.models import poseregnet, resnet, scalenet

    size = context.size
    if isinstance(model, poseregnet.PoseRegNet):
        convs = [(k, p) for _, (k, _), (p, _) in poseregnet._TRUNK]
        layouts = [chain_layout(poseregnet.INPUT_HW, convs, size)]
    elif isinstance(model, scalenet.ScaleNet):
        layouts = [chain_layout(scalenet.INPUT_HW // model.cfg.resize_factor ** t,
                                list(zip(scalenet._KERNELS, pools)), size,
                                name=f"tower {t} layer")
                   for t, pools in enumerate(scalenet._POOLS)]
    elif isinstance(model, resnet.ResNet):
        strides = [1 if b.identity else b.conv0.stride[0] for b in model.blocks]
        layouts = [resnet_layout(resnet.INPUT_HW, strides, size)]
    else:
        raise TypeError(f"no sp layout for {type(model).__name__}")
    rows = [[rows_fn(layer, context) for layer in layout] for layout in layouts]
    gather = [Gather(tuple(b - a for a, b in layout[-1].out), context) for layout in layouts]
    return Plan(rows, gather, layouts, context)


def attach(model, context: SpatialContext) -> Plan:
    """Give ``model`` its partitioned forward on this sp rank."""
    model.spatial = plan_for(model, context)
    return model.spatial

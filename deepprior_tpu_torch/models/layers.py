"""Layer building blocks and weight initializers (NCHW).

Counterpart of deepprior_tpu/models/layers.py, with the reference layer
library's semantics (src/net/):
- convolutions use 'valid' padding
- ConvPoolLayer adds the bias after max-pooling, which for a per-channel
  bias equals conv(bias) -> pool -> activation, the order used here
- pooling floors odd sizes
- He/Xavier initialization, drawn from an explicit ``torch.Generator``
- dropout p_drop = 0.3 (inverted dropout with masks from an explicit
  ``torch.Generator``; identity in eval mode)
- BatchNorm with flax's semantics (``BatchNorm``), for ResNet

Parameters stay float32; ``dtype`` is the compute type (bf16 on the card).

Scale-out (parallel/): a ``BatchNorm`` whose ``groups`` are set takes its
training statistics over the global batch of those groups' ranks, and an
``MLPHead`` whose ``split`` is set runs its Dense layers Megatron-style
over a tensor-parallel group and draws each dropout mask for the global
batch, keeping this rank's rows and columns.  Under the 'sp' axis
(parallel/spatial.py) ``ConvPool`` and ``conv2d`` take ``rows``: the
function that turns this rank's block of input rows into the rows its
output block reads, after which the convolution pads only the width.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# reference dropoutlayer.py default p = 0.3 (drop probability)
DROPOUT_RATE = 0.3
# flax nn.BatchNorm's defaults as the JAX ResNet sets them: running =
# 0.9 * running + 0.1 * batch, eps 1e-5
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def prelu(x, c):
    """Parametric ReLU, the canonical 2-arg activation for the learned-
    parameter mechanism (reference hiddenlayer.py:146-151)."""
    return torch.where(x >= 0, x, c * x)


def takes_learned_param(fn: Optional[Callable]) -> bool:
    """True when ``fn(x, c)`` expects a trainable parameter: exactly two
    required positional arguments (the JAX package's narrowing of the
    reference's ``len(getargspec(activation).args) == 2`` dispatch)."""
    if fn is None:
        return False
    try:
        params = [
            p
            for p in inspect.signature(fn).parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind
            in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
            )
        ]
    except (TypeError, ValueError):
        return False
    return len(params) == 2


def he_init_(weight: torch.Tensor, fan_in: int, generator=None):
    """variance_scaling(2.0, 'fan_in', 'normal')."""
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def xavier_init_(weight: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    """variance_scaling(1.0, 'fan_avg', 'uniform')."""
    limit = math.sqrt(3.0 * 2.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


def orthogonal_init_(weight: torch.Tensor, scale: float = 1.0, generator=None):
    """The reference's SVD-orthogonalized init option (layer.py:~90), as
    flax's ``initializers.orthogonal()`` draws it: a normal matrix's QR, Q
    with the signs of R's diagonal, of (out features, the rest flattened);
    rows orthonormal where there are at most as many as columns, columns
    otherwise.  Bits differ from flax's (another RNG); the law is the same."""
    rows = weight.shape[0]
    cols = weight.numel() // rows
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float32, device=weight.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    with torch.no_grad():
        return weight.copy_((scale * q).reshape(weight.shape))


def pool2d(x, window: Tuple[int, int], kind: str = "max"):
    """Standalone NCHW pooling with the reference PoolLayer's kinds
    (poollayer.py:39-157): 'max', 'avg' (floored, like ``ConvPool``),
    'subsample' (a strided pick) and 'none'."""
    window = tuple(window)
    if kind == "none" or window == (1, 1):
        return x
    if kind == "max":
        return F.max_pool2d(x, window, window)
    if kind == "avg":
        return F.avg_pool2d(x, window, window)
    if kind == "subsample":
        return x[:, :, :: window[0], :: window[1]]
    raise ValueError(f"unknown pool kind {kind!r}")


class ConvPool(nn.Module):
    """conv(valid) -> floor max-pool -> activation: the reference
    ConvPoolLayer (convpoollayer.py:39-305).

    packed=True is accepted and changes nothing: the JAX package's packed
    form is a TPU matrix-unit layout of the same parameters."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel: Tuple[int, int],
        pool: Tuple[int, int],
        activation: Optional[Callable] = torch.relu,
        dtype: torch.dtype = torch.float32,
        packed: bool = False,
    ):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel)
        self.pool = tuple(pool)
        self.activation = activation
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        kh, kw = self.conv.kernel_size
        he_init_(self.conv.weight, self.conv.in_channels * kh * kw, generator)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x, pool: Optional[Tuple[int, int]] = None, rows=None):
        """``pool`` overrides the layer's own pooling: ScaleNet's shared
        towers run one set of weights under each scale's pooling.  ``rows``
        (the 'sp' axis): see ``conv2d``."""
        pool = self.pool if pool is None else tuple(pool)
        x = conv2d(self.conv, x, self.dtype, rows)
        if pool != (1, 1):
            x = F.max_pool2d(x, pool, pool)
        if self.activation is not None:
            x = self.activation(x)
        return x


class BatchNorm(nn.Module):
    """Per-channel batch normalization of (B, C, H, W) maps with flax
    ``nn.BatchNorm``'s semantics (not ``nn.BatchNorm2d``'s).

    Training mode normalizes by the batch statistics and updates the
    buffers as ``running = 0.9 * running + 0.1 * batch`` with the *biased*
    variance, computed as flax does: in float32 (float64 for a float64
    input), as ``max(0, E[x^2] - E[x]^2)`` (``nn.BatchNorm2d`` stores the
    unbiased one).  Eval mode normalizes by the buffers.  Either way one
    ``F.batch_norm`` normalizes: a bf16 input with the float32 weight, bias
    and statistics is normalized in float32 and only the result is rounded
    to bf16, as flax casts after the bias.

    ``groups`` (set by parallel/train_dist.py, empty by default): process
    groups whose ranks hold the rest of the batch (the data-parallel rows
    and, under the 'sp' axis, the other blocks of rows of the map).
    Training mode then normalizes by the statistics of the global batch,
    from one differentiable all-reduce a layer of every rank's count, mean
    and centred sum of squares, and every rank's running statistics stay
    equal.  The count is the ranks' summed element count: uneven row
    blocks hold different counts."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype
        self.groups: tuple = ()

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _update_running(self, batch_mean, batch_var):
        with torch.no_grad():
            for buf, batch in ((self.running_mean, batch_mean),
                               (self.running_var, batch_var)):
                buf.mul_(BN_MOMENTUM).add_(batch, alpha=1.0 - BN_MOMENTUM)

    def _forward_global(self, x, acc, weight, bias):
        """Training mode over the global batch of ``groups``' ranks: one
        differentiable all-reduce of a buffer with a slot a rank, which holds
        the rank's element count, mean, centred sum of squares and sum of
        squares.  The variance that normalizes combines the ranks' centred
        sums (Chan, Golub and LeVeque), as exact as one device's
        ``F.batch_norm``: the fast form E[x^2] - E[x]^2 cancels over a
        crop's flat background.  The running variance keeps flax's fast
        form, as one device's does."""
        from deepprior_tpu_torch.parallel.collectives import stack_over

        xf = x.to(acc)
        c = xf.shape[1]
        n = xf.numel() // c
        mean_r = xf.mean(dim=(0, 2, 3))
        local = torch.cat([
            torch.full((1,), n, dtype=acc, device=xf.device), mean_r,
            torch.square(xf - mean_r[:, None, None]).sum(dim=(0, 2, 3)),
            torch.square(xf).sum(dim=(0, 2, 3))])
        slots = stack_over(local, self.groups)
        counts, means, m2, sq = slots[:, :1], *slots[:, 1:].split(c, dim=1)
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (m2 + counts * torch.square(means - mean)).sum(0) / total
        fast_var = torch.clamp(sq.sum(0) / total - torch.square(mean), min=0.0)
        self._update_running(mean.detach(), fast_var.detach())
        inv = torch.rsqrt(var + BN_EPS)
        y = (xf - mean[:, None, None]) * (inv * weight)[:, None, None] + bias[:, None, None]
        return y.to(self.dtype)

    def forward(self, x):
        acc = torch.promote_types(x.dtype, torch.float32)
        weight, bias = self.weight.to(acc), self.bias.to(acc)
        if self.training and self.groups:
            return self._forward_global(x, acc, weight, bias)
        if self.training:
            with torch.no_grad():
                xf = x.detach().to(acc)
                batch_mean = xf.mean(dim=(0, 2, 3))
                batch_var = torch.addcmul(torch.square(xf).mean(dim=(0, 2, 3)),
                                          batch_mean, batch_mean, value=-1.0).clamp_(min=0.0)
                self._update_running(batch_mean, batch_var)
            mean = var = None
        else:
            mean, var = self.running_mean.to(acc), self.running_var.to(acc)
        y = F.batch_norm(x, mean, var, weight, bias, self.training, 0.0, BN_EPS)
        return y.to(self.dtype)


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, x):
    """Set every ``BatchNorm``'s running statistics to the (biased) batch
    statistics of its own input on one eval-mode call ``model(x)``, layer
    after layer, so that each layer sees the input its predecessors
    normalized.  A net of random weights whose statistics are still 0 / 1
    leaves its activations unnormalized and grows them through a deep
    trunk (ResNet-47's random pose lands thousands of mm off); calibrated,
    it serves poses of a trained net's scale.  Leaves the model in eval
    mode."""
    def take_stats(mod, args):
        h = args[0].to(torch.promote_types(args[0].dtype, torch.float32))
        mod.running_mean.copy_(h.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(h.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return model


def conv2d(conv: nn.Conv2d, x, dtype: torch.dtype, rows=None):
    """``conv`` (its stride and padding) in the compute ``dtype``: the input,
    weight and bias cast to it, the float32 parameters left as they are.

    ``rows`` (the 'sp' axis, parallel/spatial.py): x holds this rank's block
    of rows; ``rows(x)`` gives the rows its output block reads, the halo
    and the edge zeros included, so the convolution pads only the width."""
    padding = conv.padding
    if rows is not None:
        x, padding = rows(x), (0, conv.padding[1])
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, padding)


class HeadSplit(NamedTuple):
    """How an ``MLPHead`` splits over ranks (parallel/train_dist.py and
    parallel/serve.py set it).

    styles:  per Dense layer, 'colwise' (its weight and bias hold this
             rank's rows of the output features), 'rowwise' (its weight
             holds this rank's columns of the input features, the bias is
             whole) or None (whole), in ``param_shardings``' Megatron order
    tp_group, tp_rank, tp_size: the tensor-parallel group
    row0, rows: this rank's first row of the global batch and the global
             batch's rows (None: the local batch is the global one), for
             the dropout masks"""

    styles: Tuple[Optional[str], ...] = ()
    tp_group: Any = None
    tp_rank: int = 0
    tp_size: int = 1
    row0: int = 0
    rows: Optional[int] = None


class MLPHead(nn.Module):
    """FC(hidden) - drop - FC(hidden) - drop - [FC(embedding)] - FC(out):
    the regression head of PoseRegNet (reference poseregnet.py:100-143).

    A 2-arg ``activation`` (e.g. ``prelu``) gives each hidden layer a
    trainable per-unit ``c{idx}`` initialised to 0.5 (hiddenlayer.py:40-169).

    ``split`` (a ``HeadSplit``, None by default) runs the Dense layers over
    a tensor-parallel group: a column-parallel layer takes the whole input
    (its gradient summed over the group) and leaves this rank's features, a
    row-parallel one sums its partial products over the group before its
    bias; each dropout mask is drawn for the global batch and every feature,
    as one device draws it, and this rank keeps its rows and columns.
    """

    def __init__(
        self,
        in_features: int,
        out_dim: int,
        hidden: int = 1024,
        dropout: bool = True,
        embedding: Optional[int] = None,
        activation: Optional[Callable] = torch.relu,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        widths = [in_features, hidden, hidden]
        if embedding is not None:
            widths.append(embedding)
        widths.append(out_dim)
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        self.activation = activation
        self.learned = takes_learned_param(activation)
        if self.learned:
            self.c0 = nn.Parameter(torch.full((hidden,), 0.5))
            self.c1 = nn.Parameter(torch.full((hidden,), 0.5))
        self.dropout = dropout
        self.dtype = dtype
        self.split: Optional[HeadSplit] = None

    def reset_parameters(self, generator=None):
        for i, lin in enumerate(self.dense):
            if i < 2:
                he_init_(lin.weight, lin.in_features, generator)
            else:
                xavier_init_(lin.weight, lin.in_features, lin.out_features, generator)
            nn.init.zeros_(lin.bias)
        if self.learned:
            nn.init.constant_(self.c0, 0.5)
            nn.init.constant_(self.c1, 0.5)

    def _style(self, i) -> Optional[str]:
        split = self.split
        return split.styles[i] if split is not None and i < len(split.styles) else None

    def _linear(self, i, x):
        lin = self.dense[i]
        style = self._style(i)
        if style is None:
            return F.linear(
                x.to(self.dtype), lin.weight.to(self.dtype), lin.bias.to(self.dtype)
            )
        from deepprior_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group

        group = self.split.tp_group
        if style == "colwise":
            x = copy_to_group(x, group)
            return F.linear(
                x.to(self.dtype), lin.weight.to(self.dtype), lin.bias.to(self.dtype)
            )
        partial = F.linear(x.to(self.dtype), lin.weight.to(self.dtype))
        return reduce_from_group(partial, group) + lin.bias.to(self.dtype)

    def _activate(self, x, idx: int):
        if self.activation is None:
            return x
        if self.learned:
            return self.activation(x, getattr(self, f"c{idx}"))
        return self.activation(x)

    def _drop(self, x, generator, after: int = 0):
        """Inverted dropout in training mode, as flax's nn.Dropout computes
        it: keep with probability 1 - rate (a Bernoulli mask drawn from
        ``generator``, or PyTorch's default generator when None), and
        divide the kept units by 1 - rate.  Under a ``split`` the mask is
        the global batch's (after Dense layer ``after``), cut to this
        rank's rows and columns."""
        if not (self.dropout and self.training):
            return x
        keep_prob = 1.0 - DROPOUT_RATE
        split = self.split
        if split is None:
            keep = torch.empty_like(x).bernoulli_(keep_prob, generator=generator)
        else:
            b, f = x.shape
            sharded = self._style(after) == "colwise"
            full = torch.empty((split.rows or b, f * split.tp_size if sharded else f),
                               dtype=x.dtype, device=x.device)
            full.bernoulli_(keep_prob, generator=generator)
            col0 = split.tp_rank * f if sharded else 0
            keep = full[split.row0:split.row0 + b, col0:col0 + f]
        # the divisor is a tensor made on x's device: on CUDA, x /
        # python_float is a multiply by the reciprocal
        divisor = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
        return torch.where(keep.bool(), x / divisor, 0.0)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, ...) features; generator draws the dropout masks."""
        x = x.reshape(x.shape[0], -1)
        x = self._drop(self._activate(self._linear(0, x), 0), generator, 0)
        x = self._drop(self._activate(self._linear(1, x), 1), generator, 1)
        for i in range(2, len(self.dense)):
            x = self._linear(i, x)
        return x

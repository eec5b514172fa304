"""ScaleNet: the 3-scale CoM refinement CNN (NCHW).

Counterpart of deepprior_tpu/models/scalenet.py (reference
src/net/scalenet.py:33-195, type 1).  Three conv towers over the full crop
and its /2 and /4 *centre crops* (zooms, not downsamples: handdetector.py:
657-669), concatenated into the FC1024-drop-FC1024-drop-FC(3) head.

Tower shapes for 128x128 input (all convs 'valid', kernels 5, 5, 3):
  s0 (128): pools (4, 2, 1) -> 8 x 11 x 11 = 968
  s1 (64):  pools (2, 2, 1) -> 8 x 11 x 11 = 968
  s2 (32):  pools (2, 1, 1) -> 8 x 8 x 8   = 512

``shared_conv`` shares each layer's kernel and bias across the towers while
each tower keeps its own pooling, the reference's copyLayer semantics
(scalenet.py:179-180).  Parameters are float32; compute runs in
``cfg.dtype``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from deepprior_tpu_torch.models.layers import ConvPool, MLPHead

INPUT_HW = 128  # the crop size the head's input width is fixed for
FEATURES = 8
# per-scale pooling schedules (scalenet.py:53-104); kernels (5, 5, 3)
_POOLS = ((4, 2, 1), (2, 2, 1), (2, 1, 1))
_KERNELS = (5, 5, 3)


class ScaleNetConfig(NamedTuple):
    num_joints: int = 1
    n_dims: int = 3
    resize_factor: int = 2
    shared_conv: bool = False
    # the JAX package's MXU lane-packed conv; no effect here
    packed_conv: bool = False
    hidden: int = 1024
    dropout: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def out_dim(self) -> int:
        return self.num_joints * self.n_dims


def tower_sides(input_hw: int = INPUT_HW, resize_factor: int = 2) -> Tuple[int, ...]:
    """The side of each tower's (FEATURES, s, s) output map."""
    sides = []
    for scale, pools in enumerate(_POOLS):
        s = input_hw // resize_factor**scale
        for k, p in zip(_KERNELS, pools):
            s = (s - k + 1) // p
        sides.append(s)
    return tuple(sides)


def multiscale_center_crops(x, resize_factor: int = 2) -> List[torch.Tensor]:
    """[x, its /2 centre crop, its /4 centre crop] of (B, C, H, W) inputs
    (handdetector.py:657-669)."""
    h, w = x.shape[-2:]
    outs = [x]
    for lvl in (1, 2):
        f = resize_factor**lvl
        dh, dw = h // f, w // f
        ys, xs = h // 2 - dh // 2, w // 2 - dw // 2
        outs.append(x[..., ys:ys + dh, xs:xs + dw])
    return outs


def _conv_stack(dtype) -> nn.ModuleList:
    """One tower's three ConvPool layers (1 -> 8 -> 8 -> 8 maps)."""
    c_in, layers = 1, []
    for k in _KERNELS:
        layers.append(ConvPool(c_in, FEATURES, (k, k), (1, 1), dtype=dtype))
        c_in = FEATURES
    return nn.ModuleList(layers)


class _Tower(nn.Module):
    """conv5 -> conv5 -> conv3 with one scale's pooling, flattened NCHW."""

    def __init__(self, pools, dtype):
        super().__init__()
        self.pools = tuple(pools)
        self.layers = _conv_stack(dtype)

    def forward(self, x):
        for layer, p in zip(self.layers, self.pools):
            x = layer(x, pool=(p, p))
        return x.flatten(1)


class _SharedConvTowers(nn.Module):
    """The three towers over one set of conv weights, each with its own
    pooling (``shared_conv_{i}`` in the flax tree)."""

    def __init__(self, dtype):
        super().__init__()
        self.layers = _conv_stack(dtype)

    def forward(self, xs):
        feats = []
        for scale, x in enumerate(xs):
            for layer, p in zip(self.layers, _POOLS[scale]):
                x = layer(x, pool=(p, p))
            feats.append(x.flatten(1))
        return feats


class ScaleNet(nn.Module):
    def __init__(self, cfg: ScaleNetConfig = ScaleNetConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.shared_conv:
            self.towers = _SharedConvTowers(cfg.dtype)
        else:
            self.towers = nn.ModuleList(_Tower(p, cfg.dtype) for p in _POOLS)
        width = sum(FEATURES * s * s
                    for s in tower_sides(INPUT_HW, cfg.resize_factor))
        self.head = MLPHead(width, cfg.out_dim, hidden=cfg.hidden,
                            dropout=cfg.dropout, dtype=cfg.dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He/Xavier init drawn from ``generator`` (or PyTorch's default)."""
        for m in self.modules():
            if isinstance(m, ConvPool):
                m.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, xs, generator: Optional[torch.Generator] = None):
        """xs: [full, /2 crop, /4 crop] (B, 1, h, w) inputs, or one
        (B, 1, 128, 128) tensor whose centre crops are taken here.
        Returns (B, out_dim) float32."""
        if isinstance(xs, torch.Tensor):
            xs = multiscale_center_crops(xs, self.cfg.resize_factor)
        if len(xs) != 3:
            raise ValueError(f"ScaleNet takes 3 scale inputs, got {len(xs)}")
        if self.cfg.shared_conv:
            feats = self.towers(xs)
        else:
            feats = [tower(x) for tower, x in zip(self.towers, xs)]
        out = self.head(torch.cat(feats, dim=1), generator=generator)
        return out.to(torch.float32)

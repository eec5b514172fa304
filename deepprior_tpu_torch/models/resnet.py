"""Pre-activation bottleneck ResNet-47 regressor (NCHW).

Counterpart of deepprior_tpu/models/resnet.py (reference
src/net/resnet.py:45-414).  A 5x5 stem conv ('same', no activation) and a
2x2 max-pool, then 4 stages of (depth - 2) / 9 = 5 bottleneck blocks of
widths (64, 128, 256, 256) (stem width 32).  Stages 1-3 downsample by
stride 2 in their projection block; stage 4's first block sees 256 == 256
channels and takes the identity path, which ignores the stride (the
reference's quirk, resnet.py:353-358), so for 128x128 inputs the head
flattens 256 x 8 x 8 = 16,384 features.  A final BatchNorm + ReLU, then
FC1024 -> FC1024 -> out (``MLPHead``).

Head types (resnet.py:119-195): 0 plain; 1 a 30-D linear bottleneck before
the decode; 2/3 dropout between the FC layers; 4 dropout and the 30-D
bottleneck (``ResNetConfig.from_reference_type``).

Bottleneck (resnet.py:349-414): BN-ReLU-1x1(c/4), BN-ReLU-3x3(c/4),
BN-ReLU-1x1(c), with the identity or a strided 1x1 projection shortcut
taken after the first BN-ReLU.  'SAME' padding: 2 for the stem, 1 for the
3x3 convs, 0 for the 1x1 convs (strided ones only ever see even sizes).
BatchNorm is ``layers.BatchNorm``, flax's semantics.  Parameters and
BatchNorm statistics are float32; compute runs in ``cfg.dtype``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepprior_tpu_torch.models.layers import BatchNorm, MLPHead, conv2d, he_init_

INPUT_HW = 128  # the crop size the head's input width is fixed for


class ResNetConfig(NamedTuple):
    """The JAX package's ResNetConfig, field for field."""

    num_joints: int = 14
    n_dims: int = 3
    depth: int = 47
    stages: Sequence[int] = (32, 64, 128, 256, 256)
    dropout: bool = False  # reference types 2/3/4
    embedding: Optional[int] = None  # reference types 1/4 use 30
    hidden: int = 1024
    dtype: torch.dtype = torch.float32
    # the JAX package's MXU lane-packed stem; no effect here
    packed_conv: bool = False

    @property
    def out_dim(self) -> int:
        return self.num_joints * self.n_dims

    @property
    def blocks_per_stage(self) -> int:
        if (self.depth - 2) % 9:
            raise ValueError(f"depth must be 9n+2, not {self.depth}")
        return (self.depth - 2) // 9

    @classmethod
    def from_reference_type(cls, type: int, num_joints: int = 14, n_dims: int = 3):
        """Map the reference's integer head types 0-4."""
        return cls(
            num_joints=num_joints,
            n_dims=n_dims,
            dropout=type in (2, 3, 4),
            embedding=30 if type in (1, 4) else None,
        )


def trunk_out_hw(cfg: ResNetConfig) -> int:
    """The side of the trunk's output map for INPUT_HW inputs: the stem's
    pool halves it, and so does each stage whose first block projects (the
    identity path ignores its stride)."""
    hw = INPUT_HW // 2
    for c_in, width in zip(cfg.stages[:-1], cfg.stages[1:]):
        if c_in != width:
            hw //= 2
    return hw


class Bottleneck(nn.Module):
    """Pre-activation bottleneck with the identity or a projection
    shortcut (flax module order: BatchNorm_0..2, Conv_0..2, Conv_3 the
    shortcut)."""

    def __init__(self, in_channels: int, features: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = features // 4
        self.identity = in_channels == features
        # the reference ignores the stride on the identity path
        stride = 1 if self.identity else stride
        self.bn0 = BatchNorm(in_channels, dtype)
        self.conv0 = nn.Conv2d(in_channels, inner, 1, stride=stride)
        self.bn1 = BatchNorm(inner, dtype)
        self.conv1 = nn.Conv2d(inner, inner, 3, padding=1)
        self.bn2 = BatchNorm(inner, dtype)
        self.conv2 = nn.Conv2d(inner, features, 1)
        self.shortcut = None if self.identity else nn.Conv2d(
            in_channels, features, 1, stride=stride)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        pre = torch.relu(self.bn0(x))  # the "common BN, ReLU" of both paths
        h = conv2d(self.conv0, pre, dt)
        h = conv2d(self.conv1, torch.relu(self.bn1(h)), dt)
        h = conv2d(self.conv2, torch.relu(self.bn2(h)), dt)
        return (x if self.identity else conv2d(self.shortcut, pre, dt)) + h


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig = ResNetConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.stem = nn.Conv2d(1, cfg.stages[0], 5, padding=2)
        blocks, c_in = [], cfg.stages[0]
        for width in cfg.stages[1:]:
            for i in range(cfg.blocks_per_stage):
                blocks.append(Bottleneck(c_in, width, 2 if i == 0 else 1, dt))
                c_in = width
        self.blocks = nn.ModuleList(blocks)
        self.bn = BatchNorm(c_in, dt)
        self.head = MLPHead(c_in * trunk_out_hw(cfg) ** 2, cfg.out_dim,
                            hidden=cfg.hidden, dropout=cfg.dropout,
                            embedding=cfg.embedding, dtype=dt)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He init for the convs (zero biases) drawn from ``generator``,
        BatchNorm to weight 1, bias 0 and statistics 0 / 1, the head as
        ``MLPHead`` does."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                kh, kw = mod.kernel_size
                he_init_(mod.weight, mod.in_channels * kh * kw, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()
        self.head.reset_parameters(generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, 1, 128, 128) normalized depth crop -> (B, out_dim) float32.
        In training mode the BatchNorm statistics update once per call and
        ``generator`` draws the dropout masks."""
        x = F.max_pool2d(conv2d(self.stem, x, self.cfg.dtype), 2, 2)
        for block in self.blocks:
            x = block(x)
        x = torch.relu(self.bn(x))
        return self.head(x, generator=generator).to(torch.float32)

"""A2J: anchor-to-joint regression from one depth crop (NCHW).

Xiong, Zhang, Xiao, Cao, Zhou and Zhou, "A2J: Anchor-to-Joint Regression
Network for 3D Articulated Pose Estimation from a Single Depth Image", ICCV
2019; the authors' release github.com/zhangboshen/A2J (src/model.py, the
network; src/anchor.py, the anchors, the decode and the loss; src/nyu.py,
the NYU recipe).  Anchors on a regular grid of the crop each vote for every
joint: a softmax over the anchors weighs each anchor's position plus its
in-plane offset, and its depth.

Trunk (``Trunk``), on a (B, 1, H, W) crop expanded to three channels as the
release does: a post-activation bottleneck ResNet-50 (torchvision's v1.5
layout, the stride on the 3x3 convolution, convolutions without bias):
  stem    Conv 7x7/2, 64 -> BN -> ReLU -> MaxPool 3x3/2 pad 1       (H/4)
  layer1  3 x Bottleneck(64, stride 1)                              256 x H/4
  layer2  4 x Bottleneck(128, stride 2)                             512 x H/8
  layer3  6 x Bottleneck(256, stride 2)         -> x3              1024 x H/16
  layer4  3 x Bottleneck(512, stride 1, dilation 2) -> x4          2048 x H/16
Heads (``Head``): 4 x [Conv3x3 256 (bias) -> BN -> ReLU] -> Conv3x3 (bias)
to A*J (classification, on x3), A*J*2 (in-plane offsets, on x4) and A*J
(depth, on x4), with A = 16 anchors a cell of the stride-16 map.  At the
published 176x176 crop and J = 14: an 11x11 map, N = 1,936 anchors,
42,687,424 parameters and 12.30 GFLOP a forward sample.

Layout (the release's ``permute(0, 3, 2, 1)``): a head's (B, C, H', W') map
is read as (B, W', H', C), so the outputs are ``cls`` (B, N, J), ``reg``
(B, N, J, 2) (row, column offsets) and ``dep`` (B, N, J), anchor
n = (w H' + h) A + a with a = 4 i + j, sitting at (row, column) =
(16 h + P[i], 16 w + P[j]) crop pixels, P = (2, 6, 10, 14).

BatchNorm has PyTorch's semantics, as the release trains with them (eps
1e-5, momentum 0.1, batch statistics in training, the unbiased variance
into the running one).  Parameters are float32; compute runs in
``cfg.dtype`` and the heads' outputs are float32 (float64 for a float64
model).

The model brings its family's choices to the trainer (train/trainer.py;
models/family.py): ``inputs`` (the crop), ``targets`` (each joint's
(row, column) in crop pixels, through the camera and the batch's crop
transform ``m``, and its depth in mm about the CoM's), ``loss`` (the
release's A2J_loss, under the span ``train.anchor``), ``joints`` (the
anchors' vote, back through ``m``'s inverse and the camera to mm about the
CoM) and ``rows``.  A right hand's crop is mirrored along its width, as a
crop regressor's (``mirror_dim``).  The forward records ``a2j.trunk`` and
``a2j.heads``.  The family trains on one device only (``one_device_only``)
and is not served yet (``serves``: the estimator refuses it).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepprior_tpu_torch.geometry import inv3x3
from deepprior_tpu_torch.utils.profiling import span

ANCHOR_STRIDE = 16  # crop pixels between the heads' cells
ANCHOR_OFFSETS = (2.0, 6.0, 10.0, 14.0)  # P: the anchors' rows and columns inside a cell
HEAD_WIDTH = 256
SPATIAL_FACTOR = 0.5  # nyu.py's spatialFactor: the in-plane term of the regression loss
REG_LOSS_FACTOR = 3.0  # nyu.py's RegLossFactor
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class A2JConfig(NamedTuple):
    num_joints: int = 14
    input_hw: int = 176  # crop pixels a side
    dtype: torch.dtype = torch.float32


class BatchNorm2d(nn.Module):
    """``nn.BatchNorm2d``'s normalization (eps 1e-5, momentum 0.1, the
    unbiased batch variance into the running one) in one ``F.batch_norm``,
    a bf16 input with the float32 weight and statistics too, and no
    ``num_batches_tracked`` (a launch a layer that nothing reads)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, BN_MOMENTUM, BN_EPS)


def _conv(conv: nn.Conv2d, x, dtype):
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding,
                    conv.dilation)


class Bottleneck(nn.Module):
    """Conv1x1 c -> BN -> ReLU -> Conv3x3 c (stride, dilation) -> BN -> ReLU ->
    Conv1x1 4c -> BN, plus the shortcut (a strided Conv1x1 4c -> BN where the
    shape changes), -> ReLU."""

    def __init__(self, c_in: int, c: int, stride: int, dilation: int, dtype):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c, 1, bias=False)
        self.bn1 = BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, stride=stride, padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(c)
        self.conv3 = nn.Conv2d(c, 4 * c, 1, bias=False)
        self.bn3 = BatchNorm2d(4 * c)
        self.down = None
        if stride != 1 or c_in != 4 * c:
            self.down = nn.Conv2d(c_in, 4 * c, 1, stride=stride, bias=False)
            self.down_bn = BatchNorm2d(4 * c)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        h = torch.relu(self.bn1(_conv(self.conv1, x, dt)))
        h = torch.relu(self.bn2(_conv(self.conv2, h, dt)))
        h = self.bn3(_conv(self.conv3, h, dt))
        skip = x if self.down is None else self.down_bn(_conv(self.down, x, dt))
        return torch.relu(h + skip)


class Trunk(nn.Module):
    """The dilated ResNet-50: (B, 3, H, W) -> (x3 (B, 1024, H/16, W/16),
    x4 (B, 2048, H/16, W/16))."""

    STAGES = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 2, 1), (512, 3, 1, 2))

    def __init__(self, dtype):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        c_in, layers = 64, []
        for c, n, stride, dilation in self.STAGES:
            blocks = []
            for k in range(n):
                blocks.append(Bottleneck(c_in, c, stride if k == 0 else 1, dilation, dtype))
                c_in = 4 * c
            layers.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = layers
        self.dtype = dtype

    def forward(self, x):
        h = torch.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        h = F.max_pool2d(h, 3, 2, 1)
        x3 = self.layer3(self.layer2(self.layer1(h)))
        return x3, self.layer4(x3)


class Head(nn.Module):
    """4 x [Conv3x3 256 (bias) -> BN -> ReLU] -> Conv3x3 ``c_out`` (bias)."""

    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.convs = nn.ModuleList(
            [nn.Conv2d(c_in if k == 0 else HEAD_WIDTH, HEAD_WIDTH, 3, padding=1)
             for k in range(4)])
        self.bns = nn.ModuleList([BatchNorm2d(HEAD_WIDTH) for _ in range(4)])
        self.out = nn.Conv2d(HEAD_WIDTH, c_out, 3, padding=1)
        self.dtype = dtype

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(_conv(conv, x, self.dtype)))
        return _conv(self.out, x, self.dtype).to(torch.promote_types(self.dtype, torch.float32))


def anchors(map_h: int, map_w: int, device=None) -> torch.Tensor:
    """(N, 2) float32 (row, column) crop pixels of the anchors of a
    (map_h, map_w) head map, in the heads' order n = (w map_h + h) A + a."""
    p = torch.tensor(ANCHOR_OFFSETS, dtype=torch.float32, device=device)
    a = len(ANCHOR_OFFSETS)
    h = torch.arange(map_h, dtype=torch.float32, device=device) * ANCHOR_STRIDE
    w = torch.arange(map_w, dtype=torch.float32, device=device) * ANCHOR_STRIDE
    rows = h[None, :, None, None] + p[None, None, :, None]  # (1, H', i, 1)
    cols = w[:, None, None, None] + p[None, None, None, :]  # (W', 1, 1, j)
    rows, cols = torch.broadcast_tensors(rows, cols)        # (W', H', i, j)
    return torch.stack([rows.reshape(-1), cols.reshape(-1)], dim=-1)


def _smooth_l1(d):
    """Smooth L1 at beta 1: 0.5 d^2 where |d| <= 1, else |d| - 0.5."""
    a = torch.abs(d)
    return torch.where(a <= 1.0, 0.5 * a * a, a - 0.5)


def _apply(m, u, v):
    """m (B, 3, 3) applied to the points (u, v) (B, J): the projected (x, y)."""
    mc = [m[:, i, None] for i in range(3)]
    x = (mc[0][..., 0] * u + mc[0][..., 1] * v) + mc[0][..., 2]
    y = (mc[1][..., 0] * u + mc[1][..., 1] * v) + mc[1][..., 2]
    w = (mc[2][..., 0] * u + mc[2][..., 1] * v) + mc[2][..., 2]
    return x / w, y / w


class A2J(nn.Module):
    # parallel/ (sharded training and serving) refuses the family
    one_device_only = True
    # realtime/fused.py refuses the family: its serving is not written yet
    serves = False
    mirror_dim = -1  # a right hand's crop, mirrored along its width

    def __init__(self, cfg: A2JConfig = A2JConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.input_hw % ANCHOR_STRIDE:
            raise ValueError(f"input_hw {cfg.input_hw} must be a multiple of {ANCHOR_STRIDE}")
        self.cfg = cfg
        dt, j, a = cfg.dtype, cfg.num_joints, len(ANCHOR_OFFSETS) ** 2
        self.trunk = Trunk(dt)
        self.cls = Head(1024, a * j, dt)
        self.reg = Head(2048, a * j * 2, dt)
        self.dep = Head(2048, a * j, dt)
        self._anchors = {}  # by device, made at the first vote there
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Every convolution's weight He-normal (std sqrt(2 / fan_in)) drawn
        from ``generator``, the heads' biases 0, BatchNorm at weight 1,
        bias 0 and statistics 0 / 1."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                with torch.no_grad():
                    mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm2d):
                mod.reset_parameters()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x (B, 1, H, W) crops -> (cls (B, N, J), reg (B, N, J, 2), dep
        (B, N, J)), float32 (float64 for a float64 model).  ``generator`` is
        accepted for the trainer's call (the network has no dropout)."""
        b, _, h, w = x.shape
        j = self.cfg.num_joints
        with span("a2j.trunk"):
            x3, x4 = self.trunk(x.expand(b, 3, h, w))
        with span("a2j.heads"):
            cls, reg, dep = self.cls(x3), self.reg(x4), self.dep(x4)
        # (B, C, H', W') read as (B, W', H', C)
        return (cls.permute(0, 3, 2, 1).reshape(b, -1, j),
                reg.permute(0, 3, 2, 1).reshape(b, -1, j, 2),
                dep.permute(0, 3, 2, 1).reshape(b, -1, j))

    # the family's choices (models/family.py), which the trainer takes from
    # the model
    def inputs(self, batch, camera, step=None, stats=None):
        return batch["crops"][:, None]

    def targets(self, labels_norm, step=None, batch=None, camera=None):
        """(B, J, 3): each joint's (row, column) in crop pixels and its depth
        in mm about the CoM's.  The joints in mm, ``labels_norm`` x cube_z / 2
        about the CoM's metric position, are projected by ``camera`` and
        taken into the crop by the batch's ``m``."""
        com, cube, m = batch["com"], batch["cube"], batch["m"]
        com3d = camera.img_to_3d(com)
        mm = labels_norm * (cube[:, 2] / 2.0)[:, None, None] + com3d[:, None, :]
        uvd = camera.three_d_to_img(mm)
        col, row = _apply(m, uvd[..., 0], uvd[..., 1])
        return torch.stack([row, col, mm[..., 2] - com3d[:, None, 2]], dim=-1)

    def vote(self, out):
        """The anchors' vote: (the softmax-weighted anchor positions
        (B, J, 2), the joints' (row, column) (B, J, 2) and depth (B, J))."""
        cls, reg, dep = out
        side = self.cfg.input_hw // ANCHOR_STRIDE
        grid = self._anchors.get(cls.device)
        if grid is None:
            grid = self._anchors[cls.device] = anchors(side, side, cls.device)
        wgt = torch.softmax(cls, dim=1)  # over the anchors
        at = torch.sum(wgt[..., None] * grid[:, None, :], dim=1)
        rc = at + torch.sum(wgt[..., None] * reg, dim=1)
        return at, rc, torch.sum(wgt * dep, dim=1)

    def _per_sample_loss(self, out, y):
        at, rc, depth = self.vote(out)
        gt_rc, gt_d = y[..., :2], y[..., 2]
        anchor_term = torch.mean(_smooth_l1(gt_rc - at).flatten(1), dim=1)
        spatial = torch.mean(_smooth_l1(gt_rc - rc).flatten(1), dim=1)
        depth_term = torch.mean(_smooth_l1(gt_d - depth), dim=1)
        return anchor_term + REG_LOSS_FACTOR * (SPATIAL_FACTOR * spatial + depth_term)

    def loss(self, out, y):
        """The release's A2J_loss (anchor.py) with nyu.py's factors: the
        anchor-surrounding term plus 3 x (0.5 x the in-plane term + the
        depth term), each a smooth L1 mean over the joints, then over the
        batch; under the span ``train.anchor``."""
        with span("train.anchor"):
            return torch.mean(self._per_sample_loss(out, y))

    def joints(self, out, batch, camera=None):
        """The joints (B, J, 3) in mm about the CoM: the vote's (row,
        column) back through ``m``'s inverse to frame pixels, back-projected
        at the CoM's depth plus the voted depth."""
        _, rc, depth = self.vote(out)
        com = batch["com"]
        u, v = _apply(inv3x3(batch["m"]), rc[..., 1], rc[..., 0])
        z = com[:, None, 2] + depth
        return camera.img_to_3d(torch.stack([u, v, z], dim=-1)) \
            - camera.img_to_3d(com)[:, None, :]

    def rows(self, out, y, batch, camera=None):
        """(cost, normalized error, joint distances in mm) of each sample:
        the loss, and the mean distance over cube_z / 2."""
        gt3d, half = batch["gt3d_crop"], batch["cube"][:, 2] / 2.0
        dist = torch.sqrt(torch.sum(torch.square(self.joints(out, batch, camera) - gt3d), dim=2))
        return self._per_sample_loss(out, y), torch.mean(dist, dim=1) / half, dist

"""V2V-PoseNet: the voxel-to-voxel 3D hand-pose network (NCDHW).

Moon, Chang and Lee, "V2V-PoseNet: Voxel-to-Voxel Prediction Network for
Accurate 3D Hand and Human Pose Estimation from a Single Depth Map", CVPR
2018 (arXiv:1711.07399); the block structure of the PyTorch
re-implementation github.com/dragonbook/V2V-PoseNet-pytorch
(src/v2v_model.py).  It takes an occupancy grid of the hand's points
(ops/voxel.py::voxelize) and returns one 3D heatmap a joint at half its
resolution (ops/voxel.py::heatmap_targets, ``decode_heatmaps``).

Blocks (every convolution with a bias; BatchNorm is ``layers.BatchNorm``,
flax's semantics, on 5-D maps; the stem's Basic(7, 16) is ``Stem``, whose
weight gradient gathers over the grid's set voxels; every convolution that
ops/hopper_conv3d.py::takes, the fourteen at 44^3 with at most 32
channels, runs its weight gradient through that module's kernel):
  Basic(k, c)  Conv3d k^3 'same' -> BN -> ReLU
  Res(a, b)    ReLU(BN(Conv3(ReLU(BN(Conv3(x))))) + skip(x)), skip = x when
               a == b, else BN(Conv1(x))
  Pool         3D max-pool, window 2, stride 2
  Up(a, b)     ConvTranspose3d 2^3, stride 2 -> BN -> ReLU
The network on a (B, 1, G, G, G) grid (G = 88 published):
  front    Basic(7, 16) -> Pool -> Res(16, 32) -> Res(32, 32) -> Res(32, 32)
  s1 = Res(32, 32)(h); h = Res(32, 64)(Pool(h)); s2 = Res(64, 64)(h)
  h = Res(128, 128)(Res(128, 128)(Res(64, 128)(Pool(h))))
  h = Up(128, 64)(h) + s2; h = Up(64, 32)(Res(64, 64)(h)) + s1
  back     Res(32, 32) -> Basic(1, 32) -> Basic(1, 32) -> Conv3d 1^3 to J
giving (B, J, G/2, G/2, G/2).  At J = 14: 3,410,222 parameters and 72.76
GFLOP a forward sample at G = 88.

Parameters are float32; compute runs in ``cfg.dtype``.  The model brings
its family's choices to the trainer (train/trainer.py): ``inputs`` (the
grid, under the span ``train.voxelize`` in a train step, its occupied and
offered voxels counted), ``targets`` (the heatmaps, under
``train.targets``), ``loss`` (the paper's summed squared error), ``joints``
(the argmax decode) and ``rows`` (evaluation's statistics).  The family
trains on one device only (``one_device_only``): the serving paths and the
sharded trainer refuse it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepprior_tpu_torch.models.layers import BatchNorm
from deepprior_tpu_torch.ops import hopper_conv3d
from deepprior_tpu_torch.ops.hopper_stem import stem_conv3d
from deepprior_tpu_torch.ops.voxel import decode_heatmaps, heatmap_loss, heatmap_targets, voxelize
from deepprior_tpu_torch.utils.profiling import span

INIT_STD = 0.001  # the re-implementation's normal init of every convolution


class V2VConfig(NamedTuple):
    num_joints: int = 14
    grid: int = 88  # input voxels a side
    cube_voxels: int = 96  # voxels across the metric cube: the edge is cube / 96
    sigma: float = 1.7  # the targets' Gaussian, in output voxels
    dtype: torch.dtype = torch.float32


def _count(stats, key, value, device):
    """Add ``value`` to the 0-d int64 counter ``stats[key]`` on ``device``,
    made at its first count."""
    if key not in stats:
        stats[key] = torch.zeros((), dtype=torch.int64, device=device)
    stats[key].add_(value)


def _conv(conv, x, dtype):
    """``conv`` (a Conv3d or a ConvTranspose3d) in the compute ``dtype``; a
    convolution that ``hopper_conv3d.takes`` through ``hopper_conv3d.conv3d``
    (its weight gradient the kernel K10 on the card)."""
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x.to(dtype), w, b, conv.stride)
    if hopper_conv3d.takes(conv):
        return hopper_conv3d.conv3d(x.to(dtype), w, b)
    return F.conv3d(x.to(dtype), w, b, conv.stride, conv.padding)


class Basic(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, dtype):
        super().__init__()
        self.conv = nn.Conv3d(c_in, c_out, kernel, padding=(kernel - 1) // 2)
        self.bn = BatchNorm(c_out, dtype)
        self.dtype = dtype

    def forward(self, x):
        return torch.relu(self.bn(_conv(self.conv, x, self.dtype)))


class Stem(Basic):
    """Basic(1, 16, 7) on the occupancy grid, the only layer whose input is
    the grid: its convolution's weight gradient gathers over the set voxels
    (ops/hopper_stem.py, the kernel K9 on the card).  Parameters as
    Basic's: ``stem.conv.weight``, ``stem.conv.bias``."""

    def __init__(self, dtype):
        super().__init__(1, 16, 7, dtype)

    def forward(self, x):
        dt = self.dtype
        h = stem_conv3d(x.to(dt), self.conv.weight.to(dt), self.conv.bias.to(dt))
        return torch.relu(self.bn(h))


class Res(nn.Module):
    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.conv1 = nn.Conv3d(c_in, c_out, 3, padding=1)
        self.bn1 = BatchNorm(c_out, dtype)
        self.conv2 = nn.Conv3d(c_out, c_out, 3, padding=1)
        self.bn2 = BatchNorm(c_out, dtype)
        self.skip_conv = None if c_in == c_out else nn.Conv3d(c_in, c_out, 1)
        self.skip_bn = None if c_in == c_out else BatchNorm(c_out, dtype)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        h = torch.relu(self.bn1(_conv(self.conv1, x, dt)))
        h = self.bn2(_conv(self.conv2, h, dt))
        skip = x if self.skip_conv is None else self.skip_bn(_conv(self.skip_conv, x, dt))
        return torch.relu(h + skip)


class Up(nn.Module):
    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.conv = nn.ConvTranspose3d(c_in, c_out, 2, stride=2)
        self.bn = BatchNorm(c_out, dtype)
        self.dtype = dtype

    def forward(self, x):
        return torch.relu(self.bn(_conv(self.conv, x, self.dtype)))


def _pool(x):
    return F.max_pool3d(x, 2, 2)


class V2VPoseNet(nn.Module):
    # realtime/ (serving) and parallel/ (sharding) refuse the family
    one_device_only = True

    def __init__(self, cfg: V2VConfig = V2VConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.grid % 8 or (cfg.cube_voxels - cfg.grid) % 2 or cfg.cube_voxels < cfg.grid:
            raise ValueError(f"grid {cfg.grid} must be a multiple of 8 and at most "
                             f"cube_voxels {cfg.cube_voxels}, with an even difference")
        self.cfg = cfg
        dt = cfg.dtype
        self.stem = Stem(dt)
        self.front = nn.ModuleList([Res(16, 32, dt), Res(32, 32, dt), Res(32, 32, dt)])
        self.skip1 = Res(32, 32, dt)
        self.enc1 = Res(32, 64, dt)
        self.skip2 = Res(64, 64, dt)
        self.enc2 = Res(64, 128, dt)
        self.mid = Res(128, 128, dt)
        self.dec2 = Res(128, 128, dt)
        self.up2 = Up(128, 64, dt)
        self.dec1 = Res(64, 64, dt)
        self.up1 = Up(64, 32, dt)
        self.back_res = Res(32, 32, dt)
        self.back = nn.ModuleList([Basic(32, 32, 1, dt), Basic(32, 32, 1, dt)])
        self.out = nn.Conv3d(32, cfg.num_joints, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Every convolution's weight from N(0, 0.001^2) drawn from
        ``generator`` and a zero bias (the re-implementation's
        ``_initialize_weights``); BatchNorm to weight 1, bias 0 and
        statistics 0 / 1."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
                with torch.no_grad():
                    mod.weight.normal_(0.0, INIT_STD, generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, 1, G, G, G) occupancy -> (B, J, G/2, G/2, G/2) float32
        heatmaps.  ``generator`` is accepted for the trainer's call (the
        network has no dropout)."""
        h = _pool(self.stem(x))
        for block in self.front:
            h = block(h)
        s1 = self.skip1(h)
        h = self.enc1(_pool(h))
        s2 = self.skip2(h)
        h = self.dec2(self.mid(self.enc2(_pool(h))))
        h = self.up2(h) + s2
        h = self.up1(self.dec1(h)) + s1
        h = self.back_res(h)
        for block in self.back:
            h = block(h)
        return _conv(self.out, h, self.cfg.dtype).to(torch.float32)

    # the family's choices, which train/trainer.py::Trainer takes from the model
    def _span(self, name, step, batch):
        """In a train step (``step`` given) the span ``name``."""
        if step is None:
            return contextlib.nullcontext()
        return span(name, id=step, batch=batch, grid=self.cfg.grid, joints=self.cfg.num_joints)

    def inputs(self, batch, camera, step=None, stats=None):
        """The occupancy grid (B, 1, G, G, G) of the batch's crops, from their
        CoMs (image coords), cubes and crop transforms (ops/voxel.py::
        voxelize); in a train step under ``train.voxelize``, its occupied
        and offered voxels added to ``stats['voxels_set']`` and
        ``['voxels_seen']`` (no host sync)."""
        crops = batch["crops"]
        with self._span("train.voxelize", step, crops.shape[0]):
            vox = voxelize(crops, batch["com"], batch["cube"], batch["m"], camera,
                           self.cfg.grid, self.cfg.cube_voxels)
            if stats is not None:
                _count(stats, "voxels_set", torch.count_nonzero(vox), vox.device)
                _count(stats, "voxels_seen", vox.numel(), vox.device)
        return vox[:, None]

    def targets(self, labels_norm, step=None):
        """The heatmaps (B, J, G/2, G/2, G/2) of the cube-normalized labels;
        in a train step under ``train.targets``."""
        cfg = self.cfg
        with self._span("train.targets", step, labels_norm.shape[0]):
            return heatmap_targets(labels_norm, cfg.grid, cfg.cube_voxels, cfg.sigma)

    def loss(self, out, y):
        return heatmap_loss(out, y)

    def joints(self, out, batch):
        """The joints (B, J, 3) in mm about the CoM at the argmax voxels."""
        cube = batch["cube"]
        return decode_heatmaps(out, torch.zeros_like(cube), cube, self.cfg.cube_voxels)

    def rows(self, out, y, batch):
        """(cost, normalized error, joint distances in mm) of each sample:
        the summed squared error, and the mean distance over cube_z / 2."""
        gt3d, half = batch["gt3d_crop"], batch["cube"][:, 2] / 2.0
        dist = torch.sqrt(torch.sum(torch.square(self.joints(out, batch) - gt3d), dim=2))
        cost = torch.sum(torch.square(out - y).flatten(1), dim=1)
        return cost, torch.mean(dist, dim=1) / half, dist

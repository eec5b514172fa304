"""V2V-PoseNet's stem convolution, its weight gradient a hand-written CUDA
kernel over the occupied voxels (K9).

The stem (models/v2v.py::Stem) is a Conv3d from the occupancy grid, one
channel, to 16 channels, 7^3 taps, padding 3.  Its input is the grid that
ops/voxel.py::voxelize writes, about 0.2% set, so its weight gradient

    dW[c, 0, k] = sum over n, q of x[n, 0, q] dy[n, c, q - k + 3]

needs only the set voxels q: a term with x = 0 is exactly zero for a finite
dy.  ``StemConv`` (``stem_conv3d``) is the convolution with that backward:

- forward: ``F.conv3d``, as every other convolution of the network;
- bias gradient: the dense sum of dy over (N, D, H, W), so a non-finite dy
  still poisons the step;
- input gradient: ``torch.nn.grad.conv3d_input``, only when asked for (the
  train step never asks: the grid is no parameter's function);
- weight gradient: ``stem_weight_grad``, which routes by the tensors'
  device: on a CUDA tensor the kernel (csrc/stem_wgrad.cu, compiled with
  nvcc on first use by ops/_build.py and called through ctypes), which
  launches or raises; on any other device ``stem_wgrad_plain``, the same
  gather over the set voxels in plain PyTorch.  There is no fallback.

The kernel replaces no Pallas kernel (the JAX package has no V2V-PoseNet);
the source says what bounds it and how it is built.  It sums in float32
whatever the input type (float32, or bfloat16 for the benchmark's
control) and returns dW in dy's type; the order of its sums is fixed, so
its result does not change from run to run.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from deepprior_tpu_torch.ops._build import I32, PTR, bind, launch

# weight-gradient calls since the last reset (each two kernel launches);
# chip_smoke.py reads it to show that the V2V step went through the kernel
LAUNCHES = {"stem_wgrad": 0}
CHANNELS, SIDE, PAD = 16, 7, 3  # the stem: 1 -> 16 channels, 7^3 taps, padding 3
WEIGHT_SHAPE = (CHANNELS, 1, SIDE, SIDE, SIDE)
BRICK = 8  # the kernel's bricks are 8^3 voxels
# the kernel's persistent grid: three 352-thread blocks on each of an H100's
# 132 SMs (csrc/stem_wgrad.cu's kBlocksPerSM); the order of the sums follows it
BLOCKS = 396
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_INT32_MAX = 2**31 - 1


build = bind("stem_wgrad.cu", {
    # x, dy, partial, out, elem_bytes, blocks, n, d, h, w, stream
    "dp_stem_wgrad": ([PTR] * 4 + [I32] * 6 + [PTR], I32),
})


def _check_shapes(x, dy):
    """x (N, 1, D, H, W) and dy (N, 16, D, H, W), or ValueError."""
    if x.dim() != 5 or x.shape[1] != 1:
        raise ValueError(f"the stem's input must be (N, 1, D, H, W), got {tuple(x.shape)}")
    want = (x.shape[0], CHANNELS, *x.shape[2:])
    if tuple(dy.shape) != want:
        raise ValueError(f"the stem's output gradient must be {want}, got {tuple(dy.shape)}")


def bricks(x) -> int:
    """The number of 8^3 bricks the kernel cuts the grid ``x`` into."""
    n, _, d, h, w = x.shape
    return n * -(-d // BRICK) * -(-h // BRICK) * -(-w // BRICK)


class StemArgs(NamedTuple):
    """A launch's tensors, from ``stem_wgrad_args``: all contiguous."""

    x: torch.Tensor        # (N, 1, D, H, W), float32 or bfloat16
    dy: torch.Tensor       # (N, 16, D, H, W), x's dtype
    partial: torch.Tensor  # (blocks, 5488) float32 scratch, each block's sums
    out: torch.Tensor      # (16, 1, 7, 7, 7) in dy's dtype, written


def stem_wgrad_args(x, dy) -> StemArgs:
    """The kernel's arguments for the stem's input ``x`` and output
    gradient ``dy``: both contiguous, of one dtype the kernel takes, the
    scratch and the output allocated here.  Works on any device: the CPU
    tests check it.  Reads nothing back to the host, so a CUDA call can be
    captured into a CUDA graph."""
    _check_shapes(x, dy)
    if x.dtype != dy.dtype or x.dtype not in _ELEM_BYTES:
        raise TypeError(f"the kernel takes x and dy both float32 or both bfloat16, got "
                        f"{x.dtype} and {dy.dtype}")
    blocks = min(BLOCKS, bricks(x))
    partial = torch.empty((blocks, CHANNELS * SIDE ** 3), dtype=torch.float32, device=x.device)
    out = torch.empty(WEIGHT_SHAPE, dtype=dy.dtype, device=dy.device)
    return StemArgs(x.contiguous(), dy.contiguous(), partial, out)


def launch_stem_wgrad(args: StemArgs) -> torch.Tensor:
    """Run the kernel on ``stem_wgrad_args``' CUDA tensors; returns
    ``args.out`` (16, 1, 7, 7, 7), written."""
    x, dy, partial, out = args
    if (x.dtype != dy.dtype or x.dtype not in _ELEM_BYTES or out.dtype != dy.dtype
            or partial.dtype != torch.float32):
        raise TypeError(f"launch_stem_wgrad takes x, dy and out of one dtype, float32 or "
                        f"bfloat16, and a float32 scratch, got {[t.dtype for t in args]}")
    _check_shapes(x, dy)
    blocks = partial.shape[0]
    n, _, d, h, w = x.shape
    if (tuple(out.shape) != WEIGHT_SHAPE or partial.dim() != 2
            or partial.shape[1] != CHANNELS * SIDE ** 3
            or not (0 < blocks <= bricks(x) or blocks == bricks(x) == 0)):
        raise ValueError(f"launch_stem_wgrad needs out {WEIGHT_SHAPE} and a scratch of "
                         f"(1 to {bricks(x)}, {CHANNELS * SIDE ** 3}), got "
                         f"{tuple(out.shape)} and {tuple(partial.shape)}")
    if d * h * w > _INT32_MAX:
        raise ValueError(f"a grid of {d}x{h}x{w} exceeds the kernel's int32 voxel index")
    launch(build, "dp_stem_wgrad", "stem weight-gradient", x, dy, partial, out,
           _ELEM_BYTES[x.dtype], blocks, n, d, h, w)
    LAUNCHES["stem_wgrad"] += 1
    return out


def stem_wgrad_plain(x, dy) -> torch.Tensor:
    """The stem's weight gradient (16, 1, 7, 7, 7) by the kernel's gather
    in plain PyTorch: for each tap k, x at the set voxels q times dy at
    q - k + 3, summed.  dy is padded with zeros by the window's reach, so a
    tap that leaves the grid adds exact zeros.  Sums in float32, or in
    float64 for float64 inputs; the result in dy's dtype.  Reads the set
    voxels back to the host: the CPU route."""
    _check_shapes(x, dy)
    acc = torch.promote_types(dy.dtype, torch.float32)
    # a voxel's 16 channels a row, the grid padded by PAD on every side
    rows = F.pad(dy, (PAD,) * 6).permute(0, 2, 3, 4, 1).reshape(-1, CHANNELS)
    d, h, w = (s + 2 * PAD for s in dy.shape[2:])
    grid = x[:, 0]
    sample, qd, qh, qw = torch.nonzero(grid, as_tuple=True)
    xv = grid[sample, qd, qh, qw].to(acc)
    # q - k + PAD in the grid is q - k + 2 PAD in the padded one
    far = ((sample * d + qd + 2 * PAD) * h + qh + 2 * PAD) * w + qw + 2 * PAD
    kw = torch.arange(SIDE, device=dy.device)
    out = torch.empty((SIDE, SIDE, SIDE, CHANNELS), dtype=acc, device=dy.device)
    for kd, kh in itertools.product(range(SIDE), repeat=2):
        at = far[:, None] - ((kd * h + kh) * w + kw)  # (set voxels, 7 taps kw)
        g = rows.index_select(0, at.reshape(-1)).to(acc)
        out[kd, kh] = (xv @ g.reshape(-1, SIDE * CHANNELS)).reshape(SIDE, CHANNELS)
    return out.permute(3, 0, 1, 2).reshape(WEIGHT_SHAPE).to(dy.dtype)


def stem_weight_grad(x, dy) -> torch.Tensor:
    """The stem's weight gradient: the kernel on CUDA tensors (it launches
    or raises), ``stem_wgrad_plain`` on any other device."""
    if x.is_cuda:
        return launch_stem_wgrad(stem_wgrad_args(x, dy))
    return stem_wgrad_plain(x, dy)


class StemConv(torch.autograd.Function):
    """``F.conv3d(x, weight, bias, padding=3)`` for the stem's shapes, with
    the backward of the module docstring."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, bias, padding=PAD)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.shape, weight, dy, padding=PAD)
        if ctx.needs_input_grad[1]:
            dw = stem_weight_grad(x, dy)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2, 3, 4))
        return dx, dw, db


def stem_conv3d(x, weight, bias) -> torch.Tensor:
    """The stem's convolution: x (N, 1, D, H, W), weight (16, 1, 7, 7, 7),
    bias (16,), all of one dtype -> (N, 16, D, H, W)."""
    if tuple(weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"the stem's weight must be {WEIGHT_SHAPE}, got {tuple(weight.shape)}")
    return StemConv.apply(x, weight, bias)

"""V2V-PoseNet's dense 3D convolutions with few channels, their weight
gradient a hand-written CUDA kernel (K10).

``takes(conv)`` is the shape rule: an ``nn.Conv3d`` with stride 1, no
dilation or groups, zero padding (k - 1) / 2 for k in ``SIDES`` on every
axis, and at most ``MAX_CHANNELS`` input and output channels.  At V2V's
published 88^3 grid these are exactly its fourteen convolutions at 44^3:
ten 3^3 (``front.*``, ``skip1``, ``back_res``) and four 1^3
(``front.0.skip_conv``, ``back.*``, ``out``).  Its 64- and 128-channel
layers, the stem (ops/hopper_stem.py) and the transposed convolutions
stay as they were.  ``Conv3dSame`` (``conv3d``) is such a convolution with
this backward:

- forward: ``F.conv3d``;
- input gradient: ``torch.nn.grad.conv3d_input``, only when asked for;
- bias gradient: the sum of dy over (N, D, H, W);
- weight gradient: ``conv3d_weight_grad``, which routes by the tensors'
  device: on a CUDA tensor the kernel (csrc/conv3d_wgrad.cu, compiled with
  nvcc on first use by ops/_build.py and called through ctypes), which
  launches or raises; on any other device ``conv3d_wgrad_plain``, the same
  implicit GEMM in plain PyTorch.  There is no fallback.

The kernel replaces no Pallas kernel (the JAX package has no V2V-PoseNet);
the source says what bounds it and how it is built.  It multiplies and
adds in float32 on the CUDA cores whatever the input type (float32, or
bfloat16 for the benchmark's control) and returns dW in dy's type; the
order of its sums is fixed, so its result does not change from run to run.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from deepprior_tpu_torch.ops._build import I32, PTR, bind, launch

# weight-gradient calls since the last reset (each two kernel launches); a
# V2V train step at the published grid makes 14; chip_smoke.py reads it
LAUNCHES = {"conv3d_wgrad": 0}
SIDES = (1, 3)       # the window sides the kernel takes
MAX_CHANNELS = 32    # input and output channels, at most: one block holds all of dW
# the kernel's persistent grid: one block of 512 threads on each of an H100's
# 132 SMs for 3^3, two of 256 for 1^3 (csrc/conv3d_wgrad.cu's kBlocksPerSM);
# the order of the sums follows it
BLOCKS = {1: 264, 3: 132}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_INT32_MAX = 2**31 - 1


build = bind("conv3d_wgrad.cu", {
    # x, dy, partial, out, elem_bytes, blocks, row, n, cin, cout, k, d, h, w, stream
    "dp_conv3d_wgrad": ([PTR] * 4 + [I32] * 10 + [PTR], I32),
})


def takes(conv) -> bool:
    """Whether ``conv`` is a convolution whose weight gradient the kernel
    takes (the module docstring's rule)."""
    if type(conv) is not nn.Conv3d:
        return False
    k = conv.kernel_size[0]
    return (conv.kernel_size == (k,) * 3 and k in SIDES
            and conv.stride == (1, 1, 1) and conv.dilation == (1, 1, 1)
            and conv.groups == 1 and conv.padding_mode == "zeros"
            and conv.padding == ((k - 1) // 2,) * 3
            and conv.in_channels <= MAX_CHANNELS and conv.out_channels <= MAX_CHANNELS)


def _check_shapes(x, dy, side):
    """x (N, Cin, D, H, W) and dy (N, Cout, D, H, W) of the kernel's sizes,
    or ValueError."""
    if side not in SIDES:
        raise ValueError(f"the kernel takes windows of side {SIDES}, got {side}")
    if x.dim() != 5 or dy.dim() != 5 or x.shape[0] != dy.shape[0] \
            or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"x and dy must be (N, C, D, H, W) of one batch and volume, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if not (1 <= x.shape[1] <= MAX_CHANNELS and 1 <= dy.shape[1] <= MAX_CHANNELS):
        raise ValueError(f"the kernel takes 1 to {MAX_CHANNELS} channels, got "
                         f"{x.shape[1]} in and {dy.shape[1]} out")
    if 0 in x.shape:
        raise ValueError(f"the kernel takes no empty volume, got {tuple(x.shape)}")


def partial_row(cin: int, side: int) -> int:
    """Floats in one block's row of the kernel's scratch: the kernel pads
    the input channels to 16 or 32 and the output channels to 32."""
    return MAX_CHANNELS * (16 if cin <= 16 else 32) * side ** 3


class Conv3dWgradArgs(NamedTuple):
    """A launch's tensors, from ``conv3d_wgrad_args``."""

    x: torch.Tensor        # (N, Cin, D, H, W), float32 or bfloat16
    dy: torch.Tensor       # (N, Cout, D, H, W), x's dtype
    partial: torch.Tensor  # (blocks, partial_row) float32 scratch, each block's sums
    out: torch.Tensor      # (Cout, Cin, k, k, k) in dy's dtype, written


def conv3d_wgrad_args(x, dy, side) -> Conv3dWgradArgs:
    """The kernel's arguments for the input ``x``, the output gradient
    ``dy`` and the window's ``side``: shapes and dtypes checked, the scratch
    and the output allocated here.  Works on any device: the CPU tests check
    it.  Reads nothing back to the host, so a CUDA call can be captured into
    a CUDA graph."""
    _check_shapes(x, dy, side)
    if x.dtype != dy.dtype or x.dtype not in _ELEM_BYTES:
        raise TypeError(f"the kernel takes x and dy both float32 or both bfloat16, got "
                        f"{x.dtype} and {dy.dtype}")
    cin, cout = x.shape[1], dy.shape[1]
    partial = torch.empty((BLOCKS[side], partial_row(cin, side)), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((cout, cin, side, side, side), dtype=dy.dtype, device=dy.device)
    return Conv3dWgradArgs(x, dy, partial, out)


def launch_conv3d_wgrad(args: Conv3dWgradArgs) -> torch.Tensor:
    """Run the kernel on ``conv3d_wgrad_args``' CUDA tensors; returns
    ``args.out`` (Cout, Cin, k, k, k), written.  Every tensor must be
    contiguous (``_build.launch`` refuses another layout)."""
    x, dy, partial, out = args
    if (x.dtype != dy.dtype or x.dtype not in _ELEM_BYTES or out.dtype != dy.dtype
            or partial.dtype != torch.float32):
        raise TypeError(f"launch_conv3d_wgrad takes x, dy and out of one dtype, float32 or "
                        f"bfloat16, and a float32 scratch, got {[t.dtype for t in args]}")
    side = out.shape[-1] if out.dim() == 5 else 0
    _check_shapes(x, dy, side)
    n, cin, d, h, w = x.shape
    cout = dy.shape[1]
    row = partial_row(cin, side)
    if (tuple(out.shape) != (cout, cin, side, side, side) or partial.dim() != 2
            or partial.shape[0] < 1 or partial.shape[1] != row):
        raise ValueError(f"launch_conv3d_wgrad needs out {(cout, cin, side, side, side)} and a "
                         f"scratch of (blocks, {row}), got {tuple(out.shape)} and "
                         f"{tuple(partial.shape)}")
    if MAX_CHANNELS * d * h * w > _INT32_MAX:
        raise ValueError(f"a volume of {d}x{h}x{w} exceeds the kernel's int32 voxel index")
    launch(build, "dp_conv3d_wgrad", "conv3d weight-gradient", x, dy, partial, out,
           _ELEM_BYTES[x.dtype], partial.shape[0], row, n, cin, cout, side, d, h, w)
    LAUNCHES["conv3d_wgrad"] += 1
    return out


def conv3d_wgrad_plain(x, dy, side) -> torch.Tensor:
    """The weight gradient (Cout, Cin, k, k, k) in plain PyTorch: for each
    tap, dy against x shifted by the tap in the zero-padded volume, summed
    over the batch and the voxels.  Sums in float32, or in float64 for
    float64 inputs; the result in dy's dtype."""
    _check_shapes(x, dy, side)
    acc = torch.promote_types(dy.dtype, torch.float32)
    n, cin, d, h, w = x.shape
    cout, pad = dy.shape[1], (side - 1) // 2
    xp = F.pad(x.to(acc), (pad,) * 6)
    rows = dy.to(acc).transpose(0, 1).reshape(cout, -1)  # (Cout, N D H W)
    out = torch.empty((cout, cin, side, side, side), dtype=acc, device=dy.device)
    for kd, kh, kw in itertools.product(range(side), repeat=3):
        shifted = xp[:, :, kd:kd + d, kh:kh + h, kw:kw + w].transpose(0, 1).reshape(cin, -1)
        out[:, :, kd, kh, kw] = rows @ shifted.T
    return out.to(dy.dtype)


def conv3d_weight_grad(x, dy, side) -> torch.Tensor:
    """The weight gradient: the kernel on CUDA tensors (it launches or
    raises), ``conv3d_wgrad_plain`` on any other device."""
    if x.is_cuda:
        return launch_conv3d_wgrad(conv3d_wgrad_args(x, dy, side))
    return conv3d_wgrad_plain(x, dy, side)


class Conv3dSame(torch.autograd.Function):
    """``F.conv3d(x, weight, bias, padding=(k - 1) // 2)`` with the backward
    of the module docstring."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, bias, padding=(weight.shape[-1] - 1) // 2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        side = weight.shape[-1]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.shape, weight, dy, padding=(side - 1) // 2)
        if ctx.needs_input_grad[1]:
            dw = conv3d_weight_grad(x.contiguous(), dy.contiguous(), side)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2, 3, 4))
        return dx, dw, db


def conv3d(x, weight, bias) -> torch.Tensor:
    """A 'same' stride-1 convolution: x (N, Cin, D, H, W), weight (Cout,
    Cin, k, k, k) with k in ``SIDES`` and both channel counts at most
    ``MAX_CHANNELS``, bias (Cout,), all of one dtype -> (N, Cout, D, H,
    W)."""
    k = weight.shape[-1]
    if weight.dim() != 5 or tuple(weight.shape[2:]) != (k,) * 3 or k not in SIDES \
            or weight.shape[0] > MAX_CHANNELS or weight.shape[1] > MAX_CHANNELS:
        raise ValueError(f"conv3d takes a weight (Cout, Cin, k, k, k), k in {SIDES}, at most "
                         f"{MAX_CHANNELS} channels each, got {tuple(weight.shape)}")
    return Conv3dSame.apply(x, weight, bias)

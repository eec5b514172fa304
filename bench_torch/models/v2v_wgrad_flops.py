"""The operations of K10, the port's weight-gradient kernel for V2V-PoseNet's
dense convolutions with few channels, counted on the benchmark's plain
reference network (``reference/v2v.py``) on the meta device, so that a change
to the program cannot change the count.

K10 takes every convolution that is not transposed, has stride 1, 'same'
padding (k - 1) / 2 with k = 1 or 3, and at most 32 input and 32 output
channels; its weight gradient is 2 x N x D x H x W x Cin x Cout x k^3
operations.  At V2V's published 88^3 grid these are the fourteen
convolutions at 44^3: 362.1 GFLOP a step at B = 8.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench_torch.reference import v2v

MAX_CHANNELS = 32
SIDES = (1, 3)
# V2V-PoseNet's blocks and widths (arXiv:1711.07399; the blocks of
# dragonbook/V2V-PoseNet-pytorch), under the names reference/v2v.py reads
RES = (("front.0", 16, 32), ("front.1", 32, 32), ("front.2", 32, 32), ("skip1", 32, 32),
       ("enc1", 32, 64), ("skip2", 64, 64), ("enc2", 64, 128), ("mid", 128, 128),
       ("dec2", 128, 128), ("dec1", 64, 64), ("back_res", 32, 32))


def layout(joints: int = 14) -> dict:
    """The reference network's parameter shapes: {name: torch.Size}."""
    shapes = {}

    def conv(p, c_in, c_out, k, transposed=False):
        shapes[p + ".weight"] = (c_in, c_out, k, k, k) if transposed else (c_out, c_in, k, k, k)
        shapes[p + ".bias"] = (c_out,)

    def bn(p, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{p}.{leaf}"] = (c,)

    conv("stem.conv", 1, 16, 7)
    bn("stem.bn", 16)
    for p, a, b in RES:
        conv(p + ".conv1", a, b, 3)
        bn(p + ".bn1", b)
        conv(p + ".conv2", b, b, 3)
        bn(p + ".bn2", b)
        if a != b:
            conv(p + ".skip_conv", a, b, 1)
            bn(p + ".skip_bn", b)
    conv("up2.conv", 128, 64, 2, transposed=True)
    bn("up2.bn", 64)
    conv("up1.conv", 64, 32, 2, transposed=True)
    bn("up1.bn", 32)
    for i in range(2):
        conv(f"back.{i}.conv", 32, 32, 1)
        bn(f"back.{i}.bn", 32)
    conv("out", 32, joints, 1)
    return {k: torch.Size(v) for k, v in shapes.items()}


def takes(x_shape, w_shape, stride, padding, dilation, transposed, groups) -> bool:
    """K10's shape rule on one convolution's arguments."""
    k = w_shape[-1]
    return (not transposed and groups == 1 and k in SIDES and tuple(w_shape[2:]) == (k,) * 3
            and list(stride) == [1, 1, 1] and list(dilation) == [1, 1, 1]
            and list(padding) == [(k - 1) // 2] * 3
            and w_shape[0] <= MAX_CHANNELS and w_shape[1] <= MAX_CHANNELS)


class _Convolutions(TorchDispatchMode):
    """Records the shapes of every convolution run under it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            x, w, _, stride, padding, dilation, transposed, _, groups = args
            self.calls.append((tuple(x.shape), tuple(w.shape), stride, padding, dilation,
                               transposed, groups))
        return func(*args, **(kwargs or {}))


def wgrad_flops(batch: int, grid: int = 88, joints: int = 14) -> int:
    """K10's operations a training step at ``batch`` on a grid^3 input: the
    weight gradients of the reference's convolutions that K10 takes."""
    w = {k: torch.empty(s, device="meta") for k, s in layout(joints).items()}
    mode = _Convolutions()
    with mode, torch.no_grad():
        v2v.net(w, torch.empty((batch, 1, grid, grid, grid), device="meta"))
    total = 0
    for x_shape, w_shape, *rule in mode.calls:
        if takes(x_shape, w_shape, *rule):
            voxels = x_shape[0] * x_shape[2] * x_shape[3] * x_shape[4]
            total += 2 * voxels * w_shape[0] * w_shape[1] * w_shape[2] ** 3
    return total

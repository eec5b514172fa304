"""Connected-component labels as a hand-written CUDA kernel (K8).

The label pass of the slice scan (ops/com.py::label_components) on the
card.  The kernel source is csrc/label.cu, block-based union-find in three
launches with no host sync; ops/_build.py compiles it with nvcc on first
use and this module calls it through ctypes.  It replaces no Pallas
kernel: the JAX package labels with a ``lax.while_loop`` of segmented
min-scans (deepprior_tpu/ops/com.py:244-275), whose eager form, the plain
version ``ops/com.py::label_scan``, syncs the host once a pass.

``label_components`` routes by the mask's device: on a CPU tensor it runs
the plain scan, on a CUDA tensor ``label_kernel`` here, which launches the
kernel or raises: there is no fallback.  Both give the same int32 labels:
each foreground pixel holds the smallest linear index of its 4-connected
component, background holds H*W.

``hard_masks`` builds the masks that take the plain scan the most passes
(spirals, serpentines, combs); the CPU tests hold the plain scan to the JAX
package on them and chip_smoke.py the kernel to the plain scan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from deepprior_tpu_torch.ops._build import I32, PTR, bind, launch

# labeling calls since the last reset (each three kernel launches per
# 65,535 frames); chip_smoke.py reads it to show that detection went
# through the kernel
LAUNCHES = {"label": 0}
# the kernel's grid takes at most this many tiles of 32 rows down a frame
_MAX_TILES_Y = 65535
_INT32_MAX = 2**31 - 1


build = bind("label.cu", {
    # mask, region, region_bytes, out, n, h, w, stream
    "dp_label": ([PTR, PTR, I32, PTR, I32, I32, I32, PTR], I32),
})


class LabelArgs(NamedTuple):
    """A launch's tensors, from ``label_args``: each (N, H, W) contiguous."""

    mask: torch.Tensor              # bool
    region: Optional[torch.Tensor]  # int32 or int64 ids, or None
    out: torch.Tensor               # int32 labels, written
    shape: torch.Size               # the labels' shape, (..., H, W)


def label_args(mask, region=None) -> LabelArgs:
    """The kernel's arguments for ``mask`` (..., H, W) and ``region`` of the
    same shape, both flattened to (N, H, W); the region as int32
    (an integer or bool dtype of at most 4 bytes, widened, so equal ids stay
    equal and unequal ones unequal) or int64; the int32 output allocated
    here.  Works on any device: the CPU tests check it.  Reads nothing back
    to the host, so a CUDA call can be captured into a CUDA graph."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    if mask.dim() < 2:
        raise ValueError(f"mask must be (..., H, W), got {tuple(mask.shape)}")
    if region is not None:
        region = torch.as_tensor(region, device=mask.device)
        if region.dtype.is_floating_point or region.dtype.is_complex:
            raise TypeError(f"region ids must be integers, got {region.dtype}")
        if region.dtype != torch.int64:
            if region.dtype.itemsize > 4:
                raise TypeError(f"region ids of {region.dtype} are not taken")
            region = region.to(torch.int32)
        if region.shape != mask.shape:
            raise ValueError(f"region {tuple(region.shape)} must have the mask's shape "
                             f"{tuple(mask.shape)}")
    h, w = mask.shape[-2:]
    flat = (-1, h, w)
    shape = mask.shape
    mask = mask.contiguous().reshape(flat)
    if region is not None:
        region = region.contiguous().reshape(flat)
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    return LabelArgs(mask, region, out, shape)


def launch_label(args: LabelArgs) -> torch.Tensor:
    """Run the kernel on ``label_args``' CUDA tensors; returns ``args.out``
    (N, H, W), written."""
    tensors = [t for t in args if isinstance(t, torch.Tensor)]
    region_bytes = 0 if args.region is None else args.region.element_size()
    if (args.mask.dtype != torch.bool or args.out.dtype != torch.int32
            or (args.region is not None and args.region.dtype not in (torch.int32, torch.int64))):
        raise TypeError(
            f"launch_label takes a bool mask, int32 or int64 regions and int32 labels, got "
            f"{[t.dtype for t in tensors]}")
    shapes = {tuple(t.shape) for t in tensors}
    if len(shapes) != 1 or args.mask.dim() != 3:
        raise ValueError(f"launch_label needs (N, H, W) tensors of one shape, got {shapes}")
    n, h, w = args.mask.shape
    if h * w > _INT32_MAX or -(-h // 32) > _MAX_TILES_Y or n > _INT32_MAX:
        raise ValueError(f"frames of {h}x{w} (x{n}) exceed the kernel's int32 labels or grid")
    launch(build, "dp_label", "label", args.mask, args.region, region_bytes, args.out, n, h, w)
    LAUNCHES["label"] += 1
    return args.out


def label_kernel(mask, region=None) -> torch.Tensor:
    """K8 on a CUDA ``mask`` (..., H, W) and optional ``region``: int32
    labels of the mask's shape, as ``ops.com.label_scan`` gives them."""
    args = label_args(mask, region)
    return launch_label(args).reshape(args.shape)


def _spiral(h, w):
    """A square spiral one pixel wide with one-pixel gaps, outside in."""
    m = np.zeros((h, w), bool)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if bottom - top >= 2:
            m[bottom, left:right + 1] = True
        if bottom - top >= 4 and right - left >= 2:
            m[top + 2:bottom + 1, left] = True
            m[top + 2, left + 1] = True  # into the next ring
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return m


def _serpentine(h, w):
    """Every other row, joined alternately at the right and the left end."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for k, y in enumerate(range(1, h, 2)):
        m[y, w - 1 if k % 2 == 0 else 0] = True
    return m


def _combs(h, w):
    """Two interleaved combs: teeth every 4 columns down from a spine along
    the top row, and up from one along the bottom row, offset by 2."""
    m = np.zeros((h, w), bool)
    m[:h - 2, ::4] = True
    m[0, :(w - 1) // 4 * 4 + 1] = True
    m[2:, 2::4] = True
    m[h - 1, 2:(w - 3) // 4 * 4 + 3] = True
    return m


def _lines(h, w):
    """One-pixel lines along both sides of tile borders, a staircase across
    tiles, and lone pixels."""
    m = np.zeros((h, w), bool)
    m[31, 5:w - 3] = m[32, 40:w - 20] = True
    m[2:h - 1, 63] = m[10:h - 10, 64] = True
    for i in range(min(h, w - 1)):
        m[i, i] = m[i, i + 1] = True
    m[h - 1, ::7] = m[::5, w - 1] = True
    return m


def hard_masks(seed: int = 0):
    """[(name, mask (..., H, W) bool, region int32 or None)]: the shapes
    that take the plain scan the most passes (a spiral and serpentines
    both ways), combs, a checkerboard of 2x2 blocks with striped regions,
    all foreground, none, one-pixel lines across tile borders, and a batch
    of 3 random masks with random regions.  Every width and all heights
    but the lines' 64 are off the kernel's 32-pixel tiles."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:40, :50]
    batch = rng.uniform(size=(3, 37, 70)) < 0.6
    return [
        ("spiral", _spiral(61, 67), None),
        ("serpentine rows", _serpentine(45, 70), None),
        ("serpentine columns", _serpentine(70, 45).T.copy(), None),
        ("combs", _combs(50, 77), None),
        ("checkerboard, striped regions", ((yy // 2 + xx // 2) % 2 == 0),
         ((yy // 3) % 2).astype(np.int32)),
        ("all foreground", np.ones((33, 65), bool), None),
        ("none", np.zeros((31, 29), bool), None),
        ("lines", _lines(64, 100), None),
        ("batch of 3 with a region", batch, rng.integers(0, 3, batch.shape).astype(np.int32)),
    ]

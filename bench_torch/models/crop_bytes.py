"""The byte and operation model of the crop kernel K1 (nearest, with the
clamp fused): the least each launch must move, each input byte read once
and each output byte written once.

A copy of the port's ``ops/hopper_crop.py::crop_bytes`` and its
``FP32_OPS_PER_PIXEL`` (counted from ``csrc/crop.cu``), kept here so that a
change to the kernel cannot change its yardstick.  Per sample: the frame
pixels that the embedded region's nearest map reaches inside the frame
(the map is separable: distinct columns times distinct rows), the
(dh, dw) output, and 14 float32 of geometry (the CoM and the clamp limits
read, M written).
"""

from __future__ import annotations

import torch

from bench_torch.reference.geometry import com_to_bounds, embed_geometry, floor_div

FP32_OPS_PER_PIXEL = 9
GEOMETRY_FLOATS = 14


def distinct_per_row(idx):
    """The number of distinct non-negative values in each row of ``idx``."""
    s = torch.sort(idx, dim=1).values
    new = (s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)
    return new.sum(dim=1) + (s[:, 0] >= 0)


def crop_bytes_per_sample(com, cube, fx, fy, frame_hw, dsize=(128, 128)):
    """(B,) int64 bytes of one K1 sample each: com (B, 3) image
    coordinates, cube (B, 3) mm, over frames of ``frame_hw``."""
    h, w = frame_hw
    dw, dh = dsize
    xs, xe, ys, ye, _, _ = com_to_bounds(com, cube, fx, fy, (h, w))
    _, off_x, off_y, sz_w, sz_h = embed_geometry(xs, xe, ys, ye, dsize)
    f32 = dict(dtype=torch.float32, device=com.device)

    def distinct(o, off, sz, extent, start, limit):
        inside = (o >= off[:, None]) & (o < (off + sz)[:, None])
        taps = start[:, None] + floor_div((o - off[:, None]) * extent[:, None], sz[:, None])
        taps = torch.where(inside & (taps >= 0) & (taps < limit), taps, -1.0)
        return distinct_per_row(taps.long())

    nx = distinct(torch.arange(dw, **f32)[None], off_x, sz_w, xe - xs, xs, w)
    ny = distinct(torch.arange(dh, **f32)[None], off_y, sz_h, ye - ys, ys, h)
    return 4 * (nx * ny + GEOMETRY_FLOATS + dh * dw)


def crop_ops(batch: int, dsize=(128, 128)) -> int:
    return FP32_OPS_PER_PIXEL * batch * dsize[0] * dsize[1]

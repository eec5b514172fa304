"""The byte and operation model of the fused augmentation warp K5: the
least each launch must move.  A copy of the port's
``ops/hopper_warp.py::warp_bytes(fused=True)`` and its
``FP32_OPS_PER_PIXEL['warp_norm']``, kept here so that a change to the
kernel cannot change its yardstick.  K5 reads each whole (H, W) float32
patch (its premax needs every pixel) and 15 float32 of parameters a
sample, and writes the (H, W) output."""

from __future__ import annotations

FP32_OPS_PER_PIXEL = 31
PARAM_FLOATS = 15


def warp_bytes(batch: int, hw=(128, 128)) -> int:
    h, w = hw
    return 4 * (batch * h * w + batch * PARAM_FLOATS + batch * h * w)


def warp_ops(batch: int, hw=(128, 128)) -> int:
    return FP32_OPS_PER_PIXEL * batch * hw[0] * hw[1]

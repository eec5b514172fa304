"""Depth-aware resize ops, plain PyTorch.

Counterpart of deepprior_tpu/ops/resize.py.  ``resize_bilinear_nd`` is the
reference's hand-written ND-aware bilinear resize (handdetector.py:132-202):
invalid (no-depth) pixels drop out of the interpolation, the weights
renormalize over the valid taps, and a pixel whose 2x2 neighbourhood has
>= 3 invalid taps becomes invalid.  ``nd_blend`` is its 4-tap blend, shared
with the fused ``'nd_bilinear'`` crop (ops/crop.py).
"""

from __future__ import annotations

import torch


def resize_nearest(img, out_hw):
    """cv2.INTER_NEAREST semantics: src = floor(dst * scale), in float32
    as the JAX package computes it."""
    img = torch.as_tensor(img)
    h, w = img.shape[-2:]
    oh, ow = out_hw
    dev = img.device
    rows = torch.floor(torch.arange(oh, dtype=torch.float32, device=dev) * (h / oh))
    cols = torch.floor(torch.arange(ow, dtype=torch.float32, device=dev) * (w / ow))
    rows = rows.long().clamp(max=h - 1)
    cols = cols.long().clamp(max=w - 1)
    return img[..., rows[:, None], cols[None, :]]


def halfpixel_taps(o, off, sz, extent, start):
    """cv2.INTER_LINEAR's half-pixel two-tap geometry along one axis:
    output coords o, the output region's offset and size (off, sz), the
    source extent and origin.  Taps clamp to [0, extent - 1]; returns the
    source taps (t0, t1) + start as floats and the blend fraction.  sz and
    extent are tensors: ``extent / sz`` must be an IEEE division (on CUDA,
    a Python-number divisor becomes a reciprocal multiply).  The op order
    of the host twin (detector_np._halfpixel_taps)."""
    sp = (o - off + 0.5) * (extent / sz) - 0.5
    t0 = torch.minimum(torch.floor(sp).clamp(min=0.0), extent - 1.0)
    frac = (sp - t0).clamp(0.0, 1.0)
    t1 = torch.minimum(t0 + 1.0, extent - 1.0)
    return t0 + start, t1 + start, frac


def resize_bilinear_nd(img, out_hw, nd_value=0.0):
    """ND-aware bilinear resize of (..., H, W) depth images: cv2's
    half-pixel grid with edge-clamped taps, then ``nd_blend``."""
    img = torch.as_tensor(img, dtype=torch.float32)
    h, w = img.shape[-2:]
    oh, ow = out_hw

    def taps(n_out, extent):
        f32 = dict(dtype=torch.float32, device=img.device)
        t0, t1, frac = halfpixel_taps(torch.arange(n_out, **f32), 0.0,
                                      torch.tensor(float(n_out), **f32),
                                      torch.tensor(float(extent), **f32), 0.0)
        return t0.long(), t1.long(), frac

    y0, y1, fy = taps(oh, h)
    x0, x1, fx = taps(ow, w)

    def tap(yi, xi):
        return img[..., yi[:, None], xi[None, :]]

    return nd_blend(tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1),
                    fy[:, None], fx[None, :], nd_value)


def nd_blend(v00, v01, v10, v11, fy, fx, nd_value=0.0):
    """The ND-aware 4-tap blend (handdetector.py:168-198): the weights of
    invalid (== nd_value) taps renormalize over the valid ones; >= 3
    invalid taps -> nd_value.  fy/fx broadcast against the taps.  The op
    order is the JAX package's."""
    w00 = (1 - fy) * (1 - fx)
    w01 = (1 - fy) * fx
    w10 = fy * (1 - fx)
    w11 = fy * fx

    m00 = v00 != nd_value
    m01 = v01 != nd_value
    m10 = v10 != nd_value
    m11 = v11 != nd_value

    wsum = w00 * m00 + w01 * m01 + w10 * m10 + w11 * m11
    vsum = (
        w00 * torch.where(m00, v00, 0.0)
        + w01 * torch.where(m01, v01, 0.0)
        + w10 * torch.where(m10, v10, 0.0)
        + w11 * torch.where(m11, v11, 0.0)
    )
    n_invalid = (~m00).int() + (~m01).int() + (~m10).int() + (~m11).int()
    # a tensor divisor: on CUDA, t / python_number is a reciprocal multiply
    return torch.where((n_invalid >= 3) | (wsum <= 0.0), nd_value,
                       vsum / torch.clamp(wsum, min=1e-12))

"""The metric-cube hand crop, plain PyTorch: the serving and training
subset of deepprior_tpu/ops/crop.py.

This is the reference the CUDA kernel (ops/hopper_crop.py) is held
against, and the path every CPU tensor takes.  Steps, as in the JAX module:

  1. ``clamp_depth``     per-image depth clamp (handdetector.py:56-61)
  2. ``com_to_bounds``   CoM + metric cube -> pixel bbox + z-range
  3. ``_embed_geometry`` aspect-preserving resize + centre-embed geometry
  4. ``crop3d``          gather + zero pad + z-threshold + embed mask, with
                         the reference's three resize methods: nearest,
                         cv2 'linear' and the ND-aware 'nd_bilinear'
  5. ``normalize_crop``  depth -> [-1, 1] (or [0, 1])

and ``warp_patch``, the augmentation's gather warp of a cropped patch.

Exactness: every division here is IEEE float32 division of two tensors.
On CUDA, PyTorch computes ``tensor / python_number`` as a multiply by the
reciprocal and ``python_number / tensor`` as ``reciprocal(t) * n`` on
every device; either can move a result by one ulp and flip a floor, so
divisors are materialised with ``torch.full_like`` (``_div``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from deepprior_tpu_torch.geometry import inv3x3
from deepprior_tpu_torch.ops.resize import halfpixel_taps, nd_blend

# the reference ctor's resize-method switch (handdetector.py:57-69)
RESIZE_METHODS = ("nearest", "linear", "nd_bilinear")


class CropConfig(NamedTuple):
    """Static crop parameters."""

    dsize: Tuple[int, int] = (128, 128)  # output (width, height)
    min_depth_floor: float = 10.0  # reference handdetector.py:58
    max_depth_ceil: float = 1500.0  # reference handdetector.py:57


def _div(a, b) -> torch.Tensor:
    """IEEE a / b with either side a Python number (see module doc)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def depth_limits(dpt: torch.Tensor, cfg: CropConfig = CropConfig()):
    """Per-image clamp limits (..., ) of (..., H, W) frames without
    materialising the cleaned frame (one min/max pass)."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    lo, hi = torch.aminmax(dpt.flatten(-2), dim=-1)
    max_d = torch.clamp(hi, max=cfg.max_depth_ceil)
    min_d = torch.clamp(lo, min=cfg.min_depth_floor)
    return min_d, max_d


def clamp_depth(dpt: torch.Tensor, cfg: CropConfig = CropConfig()):
    """Zero out-of-range depth, per image: max_depth = min(1500, max),
    min_depth = max(10, min), pixels outside [min, max] -> 0.

    Returns (cleaned dpt, min_depth, max_depth)."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    min_d, max_d = depth_limits(dpt, cfg)
    keep = (dpt >= min_d[..., None, None]) & (dpt <= max_d[..., None, None])
    return torch.where(keep, dpt, 0.0), min_d, max_d


def com_to_bounds(com, cube, fx, fy, img_hw, min_depth=10.0, max_depth=1500.0):
    """CoM (u, v, d) + metric cube (mm) -> crop bounds.

    Returns (xstart, xend, ystart, yend, zstart, zend), float32 and
    integer-valued for the first four.  floor(x + 0.5) rounding, and a
    centred half-frame crop when com_z ~ 0 (``isclose`` with the same
    default rtol/atol as ``jnp.isclose``).

    com: (..., 3); cube: (..., 3) or (3,); img_hw: (H, W).
    """
    com = torch.as_tensor(com, dtype=torch.float32)
    cube = torch.as_tensor(cube, dtype=torch.float32, device=com.device)
    cube = cube.expand(com.shape)
    h, w = img_hw
    u, v, d = com[..., 0], com[..., 1], com[..., 2]
    sx, sy, sz = cube[..., 0], cube[..., 1], cube[..., 2]

    ill = torch.isclose(d, torch.zeros_like(d))
    safe_d = torch.where(ill, 1.0, d)
    ux = _div(u * safe_d, fx)  # metric x, y of the CoM
    vy = _div(v * safe_d, fy)
    xstart = torch.floor((ux - sx / 2.0) / safe_d * fx + 0.5)
    xend = torch.floor((ux + sx / 2.0) / safe_d * fx + 0.5)
    ystart = torch.floor((vy - sy / 2.0) / safe_d * fy + 0.5)
    yend = torch.floor((vy + sy / 2.0) / safe_d * fy + 0.5)
    zstart = d - sz / 2.0
    zend = d + sz / 2.0

    xstart = torch.where(ill, float(w // 4), xstart)
    xend = torch.where(ill, float(w // 4 + w // 2), xend)
    ystart = torch.where(ill, float(h // 4), ystart)
    yend = torch.where(ill, float(h // 4 + h // 2), yend)
    zstart = torch.where(ill, float(min_depth), zstart)
    zend = torch.where(ill, float(max_depth), zend)
    return xstart, xend, ystart, yend, zstart, zend


def _exact_floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """floor(a / b) for integer-valued f32 a (|a| < 2^23) and b > 0, exact
    under a multiply-by-reciprocal division: one correction step with
    exact f32 integer products."""
    q = torch.floor(a / b)
    r = a - q * b  # exact: both products integer-valued < 2^24
    q = q + (r >= b).to(q.dtype)
    q = q - (r < 0).to(q.dtype)
    return q


def _embed_geometry(xstart, xend, ystart, yend, dsize):
    """Aspect-preserving resize + centre-embed geometry (handdetector.py:
    447-452, 468-477): the bbox (wb, hb) is resized by dsize/max(wb, hb),
    the embedded size integer-floored, and centred on the dsize canvas.

    Returns (scale, off_x, off_y, sz_w, sz_h)."""
    dw, dh = dsize
    wb = xend - xstart
    hb = yend - ystart
    wide = wb > hb
    scale = torch.where(wide, _div(float(dw), wb), _div(float(dh), hb))
    sz_w = torch.where(wide, float(dw), _exact_floor_div(wb * dh, hb))
    sz_h = torch.where(wide, _exact_floor_div(hb * dw, wb), float(dh))
    off_x = torch.floor(dw / 2.0 - sz_w / 2.0)
    off_y = torch.floor(dh / 2.0 - sz_h / 2.0)
    return scale, off_x, off_y, sz_w, sz_h


def crop_transform(com, cube, fx, fy, img_hw, dsize=(128, 128)):
    """3x3 affine M: full-frame pixel coords -> crop pixel coords
    (handdetector.py:455-477).  Batched over leading axes; (..., 3, 3)."""
    xstart, xend, ystart, yend, _, _ = com_to_bounds(com, cube, fx, fy, img_hw)
    scale, off_x, off_y, _, _ = _embed_geometry(xstart, xend, ystart, yend, dsize)
    return _transform_matrix(scale, xstart, ystart, off_x, off_y)


def _transform_matrix(scale, xstart, ystart, off_x, off_y):
    """M = centre offset @ diag(s, s, 1) @ translate(-xstart, -ystart)."""
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    row0 = torch.stack([scale, zeros, -scale * xstart + off_x], dim=-1)
    row1 = torch.stack([zeros, scale, -scale * ystart + off_y], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def resize_mode(use_bilinear=False, resize=None) -> str:
    """The resize method of a crop call: ``resize`` when given ('nearest'
    = RESIZE_CV2_NN, 'linear' = RESIZE_CV2_LINEAR, 'nd_bilinear' =
    RESIZE_BILINEAR), else the legacy flag (True -> 'linear')."""
    if resize is None:
        return "linear" if use_bilinear else "nearest"
    if resize not in RESIZE_METHODS:
        raise ValueError(
            f"unknown resize method {resize!r} (want 'nearest', "
            f"'linear' or 'nd_bilinear')"
        )
    return resize


def crop3d(dpt, com, cube, fx, fy, dsize=(128, 128), use_bilinear=False,
           method="gather", resize=None):
    """Batched fused cube crop: clamped depth (B, H, W) -> (B, dh, dw) mm
    patches and M (B, 3, 3).  Out-of-image pixels pad with 0; near pixels
    -> zstart, far -> 0; outside the embedded region -> 0.

    resize (``resize_mode``):
      'nearest'      cv2.INTER_NEAREST's floor(dst * scale) map, then the
                     z-threshold;
      'linear'       cv2.INTER_LINEAR: half-pixel taps clamped to the
                     patch, each tap z-thresholded BEFORE the blend (the
                     reference's crop -> threshold -> resize order), the
                     host twin's blend expression left to right, no
                     post-blend threshold;
      'nd_bilinear'  the same taps through the ND-aware ``nd_blend``.
    method: 'gather' or 'onehot'.  The JAX package's one-hot form is a
    TPU matrix-unit layout of the same crop; here both are this gather.
    """
    if method not in ("gather", "onehot"):
        raise ValueError(f"unknown crop method {method!r}")
    mode = resize_mode(use_bilinear, resize)
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    com = torch.as_tensor(com, dtype=torch.float32, device=dpt.device)
    cube = torch.as_tensor(cube, dtype=torch.float32, device=dpt.device)
    cube = cube.expand(com.shape)
    b, h, w = dpt.shape
    dw, dh = dsize
    xs, xe, ys, ye, zstart, zend = com_to_bounds(com, cube, fx, fy, (h, w))
    scale, off_x, off_y, sz_w, sz_h = _embed_geometry(xs, xe, ys, ye, dsize)
    wb, hb = xe - xs, ye - ys

    def col(t):  # (B,) -> (B, 1, 1)
        return t[:, None, None]

    u = torch.arange(dw, dtype=torch.float32, device=dpt.device)[None, None, :]
    v = torch.arange(dh, dtype=torch.float32, device=dpt.device)[None, :, None]
    zs, ze = col(zstart), col(zend)

    def tap(q, p):
        """Pixels (q, p), 0 outside the image, then z-thresholded
        (handdetector.py:291-295): near -> zstart, far -> 0."""
        d = _gather_patch(dpt, *torch.broadcast_tensors(q, p), 0.0)
        d = torch.where((d < zs) & (d != 0.0), zs, d)
        return torch.where(d > ze, 0.0, d)

    if mode == "nearest":
        # the nearest map is separable: p depends on u only, q on v only
        p = col(xs) + _exact_floor_div((u - col(off_x)) * col(wb), col(sz_w))
        q = col(ys) + _exact_floor_div((v - col(off_y)) * col(hb), col(sz_h))
        d = tap(q, p)
    else:
        # each tap is thresholded before the blend (crop -> threshold -> resize)
        # the embed region's taps, clamped to the patch (wb x hb at xs, ys)
        x0, x1, fxw = halfpixel_taps(u, col(off_x), col(sz_w), col(wb), col(xs))
        y0, y1, fyw = halfpixel_taps(v, col(off_y), col(sz_h), col(hb), col(ys))
        d00, d01, d10, d11 = tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1)
        if mode == "linear":
            # the host twin's exact blend expression (resize_linear)
            d = (d00 * (1 - fyw) * (1 - fxw) + d01 * (1 - fyw) * fxw
                 + d10 * fyw * (1 - fxw) + d11 * fyw * fxw)
        else:
            d = nd_blend(d00, d01, d10, d11, fyw, fxw, nd_value=0.0)
    in_embed = (
        (u >= col(off_x)) & (u < col(off_x + sz_w))
        & (v >= col(off_y)) & (v < col(off_y + sz_h))
    )
    d = torch.where(in_embed, d, 0.0)
    return d, _transform_matrix(scale, xs, ys, off_x, off_y)


def normalize_crop(crop_mm, com_z, cube_z, norm_zero_one=False):
    """Depth (mm) crop -> network input.  [-1, 1]: background 0 -> +1,
    (d - com_z) / (cube_z / 2); [0, 1]: (d - (com_z - cube_z/2)) / cube_z.
    com_z/cube_z broadcast against crop_mm's leading axes."""
    crop_mm = torch.as_tensor(crop_mm, dtype=torch.float32)
    com_z = torch.as_tensor(com_z, dtype=torch.float32, device=crop_mm.device)
    cube_z = torch.as_tensor(cube_z, dtype=torch.float32, device=crop_mm.device)
    com_z, cube_z = com_z[..., None, None], cube_z[..., None, None]
    d = torch.where(crop_mm == 0.0, com_z + cube_z / 2.0, crop_mm)
    if norm_zero_one:
        return (d - (com_z - cube_z / 2.0)) / cube_z
    return (d - com_z) / (cube_z / 2.0)


def normalized_crop(
    dpt, com, cube, fx, fy, dsize=(128, 128), norm_zero_one=False,
    use_bilinear=False, method="gather", resize=None,
):
    """Crop + normalize: the inference-time preprocessing of clamped
    frames.  Returns (crop_norm (B, dh, dw), M (B, 3, 3))."""
    crop, m = crop3d(dpt, com, cube, fx, fy, dsize, use_bilinear, method,
                     resize=resize)
    com = torch.as_tensor(com, dtype=torch.float32, device=crop.device)
    cube = torch.as_tensor(cube, dtype=torch.float32, device=crop.device)
    cube = cube.expand(com.shape)
    return normalize_crop(crop, com[..., 2], cube[..., 2], norm_zero_one), m


def nv_threshold(nv_val: float) -> float:
    """The NV mask's bound |v - nv| <= 1e-5 |nv| + 1e-8 (jnp.isclose's
    default tolerances) as the one float32 value every warp compares with."""
    return float(np.float32(1e-5 * abs(nv_val) + 1e-8))


def _gather_patch(img: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                  border: float) -> torch.Tensor:
    """img (B, H, W) at integer-valued float rows q and columns p
    (B, oh, ow); out-of-patch taps read ``border``."""
    b, h, w = img.shape
    inb = (p >= 0) & (p < w) & (q >= 0) & (q < h)
    flat = (q.clamp(0, h - 1).long() * w + p.clamp(0, w - 1).long()).reshape(b, -1)
    val = torch.gather(img.reshape(b, -1), 1, flat).reshape(q.shape)
    return torch.where(inb, val, border)


def warp_patch(patch, m_fwd, out_hw=None, border=0.0, nv_val=None,
               use_bilinear=False):
    """Warp cropped patches by forward 3x3 transforms: out(dst) =
    patch(m_fwd^-1 . dst), the gather warp of deepprior_tpu/ops/crop.py
    (cv2.warpPerspective in recropHand, handdetector.py:782-793).

    Nearest samples at floor(x + 0.5) (cv2's warp rounding); 'linear'
    (use_bilinear) blends the four taps.  Taps outside the patch read
    ``border``; values within jnp.isclose of ``nv_val`` become ``border``.
    Unlike the warp kernel (ops/hopper_warp.py) this divides by the
    projective sz, as the JAX gather does.

    patch: (..., H, W); m_fwd: (..., 3, 3) batched like patch.
    """
    patch = torch.as_tensor(patch, dtype=torch.float32)
    m_fwd = torch.as_tensor(m_fwd, dtype=torch.float32, device=patch.device)
    batch_shape = patch.shape[:-2]
    h, w = patch.shape[-2:]
    oh, ow = out_hw if out_hw is not None else (h, w)
    img = patch.reshape((-1, h, w))
    m_inv = inv3x3(m_fwd.reshape((-1, 3, 3)))
    u = torch.arange(ow, dtype=torch.float32, device=patch.device)[None, None, :]
    v = torch.arange(oh, dtype=torch.float32, device=patch.device)[None, :, None]

    def row(i):
        return (m_inv[:, i, 0, None, None] * u + m_inv[:, i, 1, None, None] * v
                + m_inv[:, i, 2, None, None])

    sx, sy, sz = row(0), row(1), row(2)
    x = sx / sz
    y = sy / sz
    if use_bilinear:
        x0, y0 = torch.floor(x), torch.floor(y)
        fx_, fy_ = x - x0, y - y0
        out = (
            _gather_patch(img, y0, x0, border) * (1 - fx_) * (1 - fy_)
            + _gather_patch(img, y0, x0 + 1, border) * fx_ * (1 - fy_)
            + _gather_patch(img, y0 + 1, x0, border) * (1 - fx_) * fy_
            + _gather_patch(img, y0 + 1, x0 + 1, border) * fx_ * fy_
        )
    else:
        out = _gather_patch(img, torch.floor(y + 0.5), torch.floor(x + 0.5),
                            border)
    if nv_val is not None:
        out = torch.where((out - nv_val).abs() <= nv_threshold(nv_val),
                          border, out)
    return out.reshape(batch_shape + (oh, ow))

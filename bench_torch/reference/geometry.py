"""The plain reference's geometry: the NYU pinhole camera, the metric-cube
crop, hand detection and the training augmentation, in plain float32
PyTorch.

These are copies of the port's plain versions (deepprior_tpu_torch's
camera.py, geometry.py, ops/crop.py, ops/com.py, ops/augment.py and the
plain K5 of ops/hopper_warp.py), kept here so that a change to the program
cannot change what its answers are held to.  Nothing here imports the
program.  Every division is of two tensors: on CUDA, PyTorch computes
``tensor / python_number`` as a multiply by the reciprocal.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

DEG2RAD = float(np.float32(math.pi / 180.0))
NV_VAL = 32000.0  # NYU's invalid-depth marker, masked after the warp
MODES = ("none", "com", "rot", "sc")


class Camera(NamedTuple):
    """(u, v, d) image coordinates <-> (x, y, z) mm; ``flip_y`` for NYU."""

    fx: float
    fy: float
    ux: float
    uy: float
    flip_y: bool
    width: int
    height: int

    @classmethod
    def of(cls, cfg: dict) -> "Camera":
        c = cfg["camera"]
        return cls(c["fx"], c["fy"], c["ux"], c["uy"], c["flip_y"], c["width"], c["height"])

    def img_to_3d(self, uvd):
        u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
        x = (u - self.ux) * d / torch.full_like(d, self.fx)
        if self.flip_y:
            y = (self.uy - v) * d / torch.full_like(d, self.fy)
        else:
            y = (v - self.uy) * d / torch.full_like(d, self.fy)
        return torch.stack([x, y, d], dim=-1)

    def three_d_to_img(self, xyz):
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        at_zero = z == 0.0
        safe_z = torch.where(at_zero, 1.0, z)
        u = x / safe_z * self.fx + self.ux
        if self.flip_y:
            v = self.uy - y / safe_z * self.fy
        else:
            v = y / safe_z * self.fy + self.uy
        u = torch.where(at_zero, self.ux, u)
        v = torch.where(at_zero, self.uy, v)
        return torch.stack([u, v, z], dim=-1)


def _div(a, b):
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def floor_div(a, b):
    """floor(a / b) for integer-valued float32 a and b > 0, exact."""
    q = torch.floor(a / b)
    r = a - q * b
    q = q + (r >= b).to(q.dtype)
    return q - (r < 0).to(q.dtype)


# ---------------------------------------------------------------------------
# the crop
# ---------------------------------------------------------------------------
def depth_limits(dpt):
    lo, hi = torch.aminmax(dpt.flatten(-2), dim=-1)
    return torch.clamp(lo, min=10.0), torch.clamp(hi, max=1500.0)


def clamp_depth(dpt):
    """Pixels outside each frame's [max(10, min), min(1500, max)] -> 0."""
    min_d, max_d = depth_limits(dpt)
    keep = (dpt >= min_d[..., None, None]) & (dpt <= max_d[..., None, None])
    return torch.where(keep, dpt, 0.0), min_d, max_d


def com_to_bounds(com, cube, fx, fy, img_hw, min_depth=10.0, max_depth=1500.0):
    cube = cube.expand(com.shape)
    h, w = img_hw
    u, v, d = com[..., 0], com[..., 1], com[..., 2]
    sx, sy, sz = cube[..., 0], cube[..., 1], cube[..., 2]
    ill = torch.isclose(d, torch.zeros_like(d))
    safe_d = torch.where(ill, 1.0, d)
    ux = _div(u * safe_d, fx)
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


def embed_geometry(xstart, xend, ystart, yend, dsize):
    """(scale, off_x, off_y, sz_w, sz_h) of the aspect-keeping embed."""
    dw, dh = dsize
    wb = xend - xstart
    hb = yend - ystart
    wide = wb > hb
    scale = torch.where(wide, _div(float(dw), wb), _div(float(dh), hb))
    sz_w = torch.where(wide, float(dw), floor_div(wb * dh, hb))
    sz_h = torch.where(wide, floor_div(hb * dw, wb), float(dh))
    off_x = torch.floor(dw / 2.0 - sz_w / 2.0)
    off_y = torch.floor(dh / 2.0 - sz_h / 2.0)
    return scale, off_x, off_y, sz_w, sz_h


def transform_matrix(scale, xstart, ystart, off_x, off_y):
    zeros, ones = torch.zeros_like(scale), torch.ones_like(scale)
    row0 = torch.stack([scale, zeros, -scale * xstart + off_x], dim=-1)
    row1 = torch.stack([zeros, scale, -scale * ystart + off_y], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def crop_transform(com, cube, fx, fy, img_hw, dsize=(128, 128)):
    xs, xe, ys, ye, _, _ = com_to_bounds(com, cube, fx, fy, img_hw)
    scale, off_x, off_y, _, _ = embed_geometry(xs, xe, ys, ye, dsize)
    return transform_matrix(scale, xs, ys, off_x, off_y)


def gather_patch(img, q, p, border):
    """img (B, H, W) at integer-valued rows q and columns p; outside reads
    ``border``."""
    b, h, w = img.shape
    inb = (p >= 0) & (p < w) & (q >= 0) & (q < h)
    flat = (q.clamp(0, h - 1).long() * w + p.clamp(0, w - 1).long()).reshape(b, -1)
    val = torch.gather(img.reshape(b, -1), 1, flat).reshape(q.shape)
    return torch.where(inb, val, border)


def crop3d(dpt, com, cube, fx, fy, dsize=(128, 128)):
    """Nearest cube crop of clamped frames (B, H, W): (B, dh, dw) mm and M."""
    cube = cube.expand(com.shape)
    b, h, w = dpt.shape
    dw, dh = dsize
    xs, xe, ys, ye, zstart, zend = com_to_bounds(com, cube, fx, fy, (h, w))
    scale, off_x, off_y, sz_w, sz_h = embed_geometry(xs, xe, ys, ye, dsize)
    wb, hb = xe - xs, ye - ys

    def col(t):
        return t[:, None, None]

    u = torch.arange(dw, dtype=torch.float32, device=dpt.device)[None, None, :]
    v = torch.arange(dh, dtype=torch.float32, device=dpt.device)[None, :, None]
    p = col(xs) + floor_div((u - col(off_x)) * col(wb), col(sz_w))
    q = col(ys) + floor_div((v - col(off_y)) * col(hb), col(sz_h))
    d = gather_patch(dpt, *torch.broadcast_tensors(q, p), 0.0)
    zs, ze = col(zstart), col(zend)
    d = torch.where((d < zs) & (d != 0.0), zs, d)
    d = torch.where(d > ze, 0.0, d)
    in_embed = ((u >= col(off_x)) & (u < col(off_x + sz_w))
                & (v >= col(off_y)) & (v < col(off_y + sz_h)))
    d = torch.where(in_embed, d, 0.0)
    return d, transform_matrix(scale, xs, ys, off_x, off_y)


def normalized_crop(dpt, com, cube, fx, fy, dsize=(128, 128)):
    """Crop of clamped frames normalized to [-1, 1] (background +1), and M."""
    crop, m = crop3d(dpt, com, cube, fx, fy, dsize)
    cube = cube.expand(com.shape)
    com_z, cube_z = com[:, 2, None, None], cube[:, 2, None, None]
    d = torch.where(crop == 0.0, com_z + cube_z / 2.0, crop)
    return (d - com_z) / (cube_z / 2.0), m


# ---------------------------------------------------------------------------
# hand detection: the slice scan, the first big blob, iterative refinement
# ---------------------------------------------------------------------------
def _grid(h, w, device):
    cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return cols, rows


def _moments(mask, value):
    h, w = mask.shape[-2:]
    cols, rows = _grid(h, w, mask.device)
    num = mask.sum((-2, -1)).to(torch.float32)
    safe = num.clamp(min=1.0)
    cx = torch.where(mask, cols, 0.0).sum((-2, -1)) / safe
    cy = torch.where(mask, rows, 0.0).sum((-2, -1)) / safe
    cz = torch.where(mask, value, 0.0).sum((-2, -1)) / safe
    return torch.stack([cx, cy, cz], dim=-1), num


def _first_argmin(x):
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device).expand(x.shape)
    hit = x == x.min(dim=-1, keepdim=True).values
    return torch.where(hit, iota, n).min(dim=-1).values


def _masked_com_in_bounds(dpt, xstart, xend, ystart, yend, zstart, zend,
                          min_depth, max_depth):
    b, h, w = dpt.shape
    cols, rows = _grid(h, w, dpt.device)

    def c(t):
        return t[:, None, None]

    in_bbox = ((cols >= c(xstart)) & (cols < c(xend))
               & (rows >= c(ystart)) & (rows < c(yend)))
    valid = in_bbox & (dpt != 0.0) & (dpt <= c(zend))
    value = torch.maximum(dpt, c(zstart))
    valid = valid & (value <= c(max_depth)) & (value >= c(min_depth))
    com, num = _moments(valid, value)
    two = torch.full_like(xstart, 2.0)
    ccx = xstart + floor_div(xend - xstart, two)
    ccy = ystart + floor_div(yend - ystart, two)
    inside = (ccx >= 0) & (ccx < w) & (ccy >= 0) & (ccy < h)
    raw = dpt[torch.arange(b, device=dpt.device),
              ccy.clamp(0, h - 1).long(), ccx.clamp(0, w - 1).long()]
    center_d = torch.where(inside, raw, 0.0)
    center_d = torch.where((center_d != 0.0) & (center_d < zstart), zstart, center_d)
    center_d = torch.where(center_d > zend, 0.0, center_d)
    fallback = torch.stack([xstart, ystart, center_d], dim=-1)
    return torch.where((num > 0)[:, None], com, fallback)


def refine_com_iterative(dpt, com, cube, fx, fy, num_iter, min_depth, max_depth):
    cube = cube.expand(com.shape)
    for _ in range(num_iter):
        xs, xe, ys, ye, zs, ze = com_to_bounds(com, cube, fx, fy, dpt.shape[-2:])
        com = _masked_com_in_bounds(dpt, xs, xe, ys, ye, zs, ze, min_depth, max_depth)
    return com


def _shift(x, axis, offset, fill):
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = abs(offset)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if offset > 0:
        return torch.cat([pad, x.narrow(axis, 0, n - offset)], dim=axis)
    return torch.cat([x.narrow(axis, -offset, n + offset), pad], dim=axis)


def _scan(fn, x, axis, reverse):
    if reverse:
        return fn(x.flip(axis), axis).flip(axis)
    return fn(x, axis)


def _seg_min_scan(lab, mask, axis, region):
    """Min of ``lab`` over each run of connected pixels along ``axis``."""
    axis = axis % lab.dim()
    k = lab.shape[-1] * lab.shape[-2] + 1

    def cumsum(x, dim):
        return torch.cumsum(x, dim, dtype=torch.int32)

    def cummin(x, dim):
        return torch.cummin(x, dim).values

    def directional(offset):
        r = ~mask | (region != _shift(region, axis, offset, -1))
        cnt = _scan(cumsum, r.to(torch.int32), axis, offset < 0)
        return _scan(cummin, lab - k * cnt, axis, offset < 0) + k * cnt

    return torch.minimum(directional(1), directional(-1))


def label_components(mask, region):
    """4-connected labels within equal ``region`` ids: each foreground
    pixel holds its component's smallest linear index, background H*W."""
    h, w = mask.shape[-2:]
    big = h * w
    iota = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, iota, big)
    while True:
        lab2 = torch.where(mask, _seg_min_scan(lab, mask, -1, region), big)
        lab3 = torch.where(mask, _seg_min_scan(lab2, mask, -2, region), big)
        if torch.equal(lab3, lab):
            return lab3
        lab = lab3


def _first_big_blob_com(valid, q, dpt, num_slices, min_area):
    b, h, w = valid.shape
    hw = h * w
    lab = label_components(valid, q)
    flat = lab.reshape(b, hw).long()
    counts = torch.zeros((b, hw + 1), dtype=torch.float32, device=valid.device)
    counts.scatter_add_(1, flat, valid.reshape(b, hw).to(torch.float32))
    counts[:, hw] = 0.0
    slice_of = torch.zeros((b, hw + 1), dtype=torch.int32, device=valid.device)
    slice_of.scatter_reduce_(1, flat, q.reshape(b, hw).to(torch.int32) + 1, reduce="amax")
    qualifies = counts > float(min_area)
    first_slice = torch.where(qualifies, slice_of, num_slices + 2).min(dim=1).values
    found = first_slice <= num_slices + 1
    target = qualifies & (slice_of == first_slice[:, None])
    best = _first_argmin(-torch.where(target, counts, -1.0))
    blob = (lab == best[:, None, None].to(lab.dtype)) & valid
    return found, _moments(blob, dpt)[0]


def detect(dpt, cube, fx, fy, num_slices=20, min_area=200, num_iter=5):
    """Raw frames (B, H, W) -> CoMs (B, 3): the first of ``num_slices``
    near-to-far depth slices whose largest blob passes ``min_area`` pixels,
    its blob's CoM refined ``num_iter`` times; zeros where none passes."""
    dc, dmin, dmax = clamp_depth(dpt)
    dz = torch.clamp(_div(dmax - dmin, float(num_slices)), min=1e-6)
    q = torch.floor((dc - dmin[:, None, None]) / dz[:, None, None])
    q = q.clamp(0, num_slices - 1).to(torch.int32)
    found, com0 = _first_big_blob_com(dc > 0.0, q, dc, num_slices, min_area)
    com = refine_com_iterative(dc, com0, cube, fx, fy, num_iter, dmin, dmax)
    return torch.where(found[:, None], com, 0.0)


# ---------------------------------------------------------------------------
# the training augmentation (com / rot / sc / none) and its labels
# ---------------------------------------------------------------------------
def inv3x3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = torch.ones_like(det) / det
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def matmul3x3(a, b):
    p = a[..., :, :, None] * b[..., None, :, :]
    return (p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]


def rotation_matrix_2d(center, angle_deg):
    a = angle_deg * DEG2RAD
    c, s = torch.cos(a), torch.sin(a)
    cx, cy = center[..., 0], center[..., 1]
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([
        torch.stack([c, -s, cx - c * cx + s * cy], dim=-1),
        torch.stack([s, c, cy - s * cx - c * cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def rotate_points_2d(pts, center, angle_deg):
    a = angle_deg * DEG2RAD
    c, s = torch.cos(a), torch.sin(a)
    dx = pts[..., 0] - center[..., 0]
    dy = pts[..., 1] - center[..., 1]
    x = dx * c - dy * s + center[..., 0]
    y = dx * s + dy * c + center[..., 1]
    return torch.cat([torch.stack([x, y], dim=-1), pts[..., 2:]], dim=-1)


def sample_augment_params(generator, batch, num_modes, sigma_com, sigma_sc, rot_range):
    """The draws of one step, in the program's order on ``generator``."""
    kw = dict(generator=generator, device=generator.device)
    mode = torch.randint(0, num_modes, (batch,), **kw)
    off = torch.randn((batch, 3), **kw) * sigma_com
    rot = torch.empty((batch,), device=generator.device).uniform_(
        -rot_range, rot_range, generator=generator)
    sc = torch.abs(1.0 + torch.randn((batch,), **kw) * sigma_sc)
    return mode, off, rot, sc


def augment(params, crops, gt3d, com, cube, m, cam: Camera, aug_modes):
    """Augmented normalized crops (B, H, W) and labels normalized by the new
    cube (B, J, 3): the warp of each patch by its mode's transform at the
    nearest source pixel floor(x + 0.5), the invalid-depth mask, the recrop
    z-threshold and the renormalization."""
    b, h, w = crops.shape
    dev = crops.device
    mode_idx, off, rot, sc = params
    is_mode = {name: torch.zeros((b,), dtype=torch.bool, device=dev) for name in MODES}
    for i, name in enumerate(aug_modes):
        is_mode[name] = is_mode[name] | (mode_idx == i)
    off = torch.where(is_mode["com"][:, None], off, 0.0)
    rot = torch.remainder(torch.where(is_mode["rot"], rot, 0.0), 360.0)
    sc = torch.where(is_mode["sc"], sc, 1.0)
    img_hw = (cam.height, cam.width)
    com3d = cam.img_to_3d(com)
    new_com3d_c = com3d + off
    new_com = torch.where(is_mode["com"][:, None], cam.three_d_to_img(new_com3d_c), com)
    new_cube = torch.where(is_mode["sc"][:, None], cube * sc[:, None], cube)
    m_new = crop_transform(new_com, new_cube, cam.fx, cam.fy, img_hw, (w, h))
    recrop = is_mode["com"] | is_mode["sc"]
    center = torch.tensor([w // 2, h // 2], dtype=torch.float32, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(b, 3, 3)
    a_fwd = torch.where(recrop[:, None, None], matmul3x3(m_new, inv3x3(m)),
                        torch.where(is_mode["rot"][:, None, None],
                                    rotation_matrix_2d(center.expand(b, 2), rot), eye))
    _, _, _, _, zs_t, ze_t = com_to_bounds(new_com, cube, cam.fx, cam.fy, img_hw)

    def col(t):
        return t[:, None, None]

    # unnormalize, warp, threshold, renormalize
    com_z, cube_z = com[:, 2], cube[:, 2]
    img = crops * col(cube_z / 2.0) + col(com_z)
    premax = torch.amax(img, dim=(1, 2))
    a_inv = inv3x3(a_fwd)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    x = (a_inv[:, 0, 0, None, None] * u + a_inv[:, 0, 1, None, None] * v) + a_inv[:, 0, 2, None, None]
    y = (a_inv[:, 1, 0, None, None] * u + a_inv[:, 1, 1, None, None] * v) + a_inv[:, 1, 2, None, None]
    warped = gather_patch(img, torch.floor(y + 0.5), torch.floor(x + 0.5), 0.0)
    nv_thresh = float(np.float32(1e-5 * abs(NV_VAL) + 1e-8))
    warped = torch.where((warped - NV_VAL).abs() <= nv_thresh, 0.0, warped)
    thresh = col(recrop)
    zs_b, ze_b = col(zs_t), col(ze_t)
    d = torch.where(thresh & (warped < zs_b) & (warped != 0.0), zs_b, warped)
    d = torch.where(thresh & (d > ze_b), 0.0, d)
    new_z, new_cz = new_com[:, 2], new_cube[:, 2]
    zstart, zend = col(new_z - new_cz / 2.0), col(new_z + new_cz / 2.0)
    d = torch.where(d == premax[:, None, None], zend, d)
    d = torch.where(d == 0.0, zend, d)
    d = torch.clamp(d, zstart, zend)
    out = (d - col(new_z)) / col(new_cz / 2.0)

    lab_com = gt3d + (com3d - new_com3d_c)[:, None, :]
    joint2d = cam.three_d_to_img(gt3d + com3d[:, None, :])
    lab_rot = cam.img_to_3d(rotate_points_2d(joint2d, com[:, None, :2], rot[:, None])) \
        - com3d[:, None, :]
    labels = torch.where(is_mode["com"][:, None, None], lab_com,
                         torch.where(is_mode["rot"][:, None, None], lab_rot, gt3d))
    return out, labels / (new_cube[:, 2] / 2.0)[:, None, None]

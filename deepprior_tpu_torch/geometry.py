"""2D point transforms on tensors, batched over leading axes.

Counterpart of the 2D part of deepprior_tpu/geometry.py (reference
src/data/transformations.py:34-102), plus the numpy twins that host-side
code (the synthetic frames, the pose prior's fit) uses.  Same op order as
the JAX functions; divisors that are not powers of two are tensors (see
ops/crop.py's module note).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# float32(pi / 180), the constant jnp.deg2rad multiplies by
_DEG2RAD = float(np.float32(math.pi / 180.0))


def _deg2rad(angle_deg) -> torch.Tensor:
    a = torch.as_tensor(angle_deg, dtype=torch.float32)
    return a * _DEG2RAD


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) matrices via the adjugate, in
    the JAX package's op order."""
    m = torch.as_tensor(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = torch.ones_like(det) / det
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def matmul3x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as elementwise products summed in a fixed
    order, so that the CPU and the card give the same bits (a batched
    GEMM sums in a library-chosen order, with FMAs on the card)."""
    p = a[..., :, :, None] * b[..., None, :, :]  # (..., i, j, k)
    return (p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]


def transform_points_2d(pts, m) -> torch.Tensor:
    """Apply a 3x3 homogeneous transform to (..., 2+) points; trailing
    coordinates (e.g. depth) pass through."""
    pts = torch.as_tensor(pts)
    m = torch.as_tensor(m, dtype=pts.dtype, device=pts.device)
    x, y = pts[..., 0], pts[..., 1]
    out = [(m[i, 0] * x + m[i, 1] * y) + m[i, 2] for i in range(3)]
    xy = torch.stack([out[0] / out[2], out[1] / out[2]], dim=-1)
    if pts.shape[-1] > 2:
        return torch.cat([xy, pts[..., 2:]], dim=-1)
    return xy


def rotation_matrix_2d(center, angle_deg) -> torch.Tensor:
    """(..., 3, 3) matrix rotating by ``angle_deg`` about ``center``
    (..., 2): x' = x cos - y sin, y' = x sin + y cos (the reference's
    convention, transformations.py:71-89)."""
    a = _deg2rad(angle_deg)
    c, s = torch.cos(a), torch.sin(a)
    center = torch.as_tensor(center, dtype=torch.float32, device=a.device)
    cx, cy = center[..., 0], center[..., 1]
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    # T(center) @ R @ T(-center)
    return torch.stack(
        [
            torch.stack([c, -s, cx - c * cx + s * cy], dim=-1),
            torch.stack([s, c, cy - s * cx - c * cy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def rotate_points_2d(pts, center, angle_deg) -> torch.Tensor:
    """Rotate (..., 2+) points about a 2D center; depth passes through."""
    pts = torch.as_tensor(pts)
    center = torch.as_tensor(center, dtype=pts.dtype, device=pts.device)
    a = _deg2rad(angle_deg)
    c, s = torch.cos(a), torch.sin(a)
    dx = pts[..., 0] - center[..., 0]
    dy = pts[..., 1] - center[..., 1]
    x = dx * c - dy * s + center[..., 0]
    y = dx * s + dy * c + center[..., 1]
    out = torch.stack([x, y], dim=-1)
    if pts.shape[-1] > 2:
        return torch.cat([out, pts[..., 2:]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# numpy twins (copies of the JAX package's, for host-side code)
# ---------------------------------------------------------------------------
def transform_points_2d_np(pts, m):
    """Numpy twin of transform_points_2d."""
    pts = np.asarray(pts, np.float32)
    m = np.asarray(m, np.float32)
    xy1 = np.concatenate(
        [pts[..., :2], np.ones(pts.shape[:-1] + (1,), np.float32)], axis=-1
    )
    out = xy1 @ m.T
    xy = out[..., :2] / out[..., 2:3]
    if pts.shape[-1] > 2:
        return np.concatenate([xy, pts[..., 2:]], axis=-1)
    return xy


def rotate_points_2d_np(pts, center, angle_deg):
    """Numpy twin of rotate_points_2d (float64)."""
    pts = np.asarray(pts, np.float64)
    center = np.asarray(center, np.float64)
    a = np.deg2rad(np.asarray(angle_deg, np.float64))
    c, s = np.cos(a), np.sin(a)
    dx = pts[..., 0] - center[..., 0]
    dy = pts[..., 1] - center[..., 1]
    x = dx * c - dy * s + center[..., 0]
    y = dx * s + dy * c + center[..., 1]
    out = np.stack([x, y], axis=-1)
    if pts.shape[-1] > 2:
        return np.concatenate([out, pts[..., 2:]], axis=-1)
    return out


def rotate_points_3d_np(pts, center, angle_x_deg, angle_y_deg, angle_z_deg):
    """Rotate (..., 3) points about a 3D center by 'rxyz' Euler angles in
    degrees (R = Rx Ry Rz, reference transformations.py:105-155), float64;
    the pose prior's rot3d sampling uses it."""
    pts = np.asarray(pts, np.float64)
    center = np.asarray(center, np.float64)
    ax, ay, az = np.broadcast_arrays(
        np.deg2rad(np.asarray(angle_x_deg, np.float64)),
        np.deg2rad(np.asarray(angle_y_deg, np.float64)),
        np.deg2rad(np.asarray(angle_z_deg, np.float64)),
    )
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    one, zero = np.ones_like(cx), np.zeros_like(cx)
    rx = np.stack(
        [np.stack([one, zero, zero], -1),
         np.stack([zero, cx, -sx], -1),
         np.stack([zero, sx, cx], -1)], -2)
    ry = np.stack(
        [np.stack([cy, zero, sy], -1),
         np.stack([zero, one, zero], -1),
         np.stack([-sy, zero, cy], -1)], -2)
    rz = np.stack(
        [np.stack([cz, -sz, zero], -1),
         np.stack([sz, cz, zero], -1),
         np.stack([zero, zero, one], -1)], -2)
    r = rx @ ry @ rz
    return np.einsum("...ij,...j->...i", r, pts - center) + center

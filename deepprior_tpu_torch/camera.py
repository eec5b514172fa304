"""Pinhole camera models for depth-image hand datasets.

Counterpart of deepprior_tpu/camera.py.  Image coordinates are (u, v, d):
u = column, v = row, d = depth in mm; world coordinates are (x, y, z) in
mm, camera-centred.  ``flip_y=True`` encodes cameras whose projection
inverts the vertical axis (v = uy - y/z*fy): MSRA15 and NYU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Intrinsics of a depth camera (focal lengths + principal point)."""

    fx: float
    fy: float
    ux: float
    uy: float
    flip_y: bool = False
    # native sensor resolution (width, height)
    width: int = 320
    height: int = 240

    def img_to_3d(self, uvd: torch.Tensor) -> torch.Tensor:
        """Back-project image coords (..., 3) (u, v, d) -> metric (x, y, z).

        The focal lengths divide as tensors: on CUDA, PyTorch turns a
        division by a Python number into a multiply by its reciprocal,
        which is not IEEE division and can differ by one ulp.
        """
        uvd = torch.as_tensor(uvd, dtype=torch.float32)
        u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
        x = (u - self.ux) * d / torch.full_like(d, self.fx)
        if self.flip_y:
            y = (self.uy - v) * d / torch.full_like(d, self.fy)
        else:
            y = (v - self.uy) * d / torch.full_like(d, self.fy)
        return torch.stack([x, y, d], dim=-1)

    def three_d_to_img(self, xyz: torch.Tensor) -> torch.Tensor:
        """Project metric (..., 3) -> image coords (u, v, d); z == 0 maps
        to the principal point with d = 0 (reference importers.py:104-119)."""
        xyz = torch.as_tensor(xyz, dtype=torch.float32)
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

    # numpy twins for host-side code (the synthetic generator)
    def img_to_3d_np(self, uvd):
        uvd = np.asarray(uvd, np.float32)
        u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
        x = (u - self.ux) * d / self.fx
        if self.flip_y:
            y = (self.uy - v) * d / self.fy
        else:
            y = (v - self.uy) * d / self.fy
        return np.stack([x, y, d], axis=-1)

    def three_d_to_img_np(self, xyz):
        """Project metric (..., 3) -> image coords; z == 0 maps to the
        principal point with d = 0."""
        xyz = np.asarray(xyz, np.float32)
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        safe_z = np.where(z == 0.0, 1.0, z)
        u = x / safe_z * self.fx + self.ux
        if self.flip_y:
            v = self.uy - y / safe_z * self.fy
        else:
            v = y / safe_z * self.fy + self.uy
        u = np.where(z == 0.0, self.ux, u)
        v = np.where(z == 0.0, self.uy, v)
        return np.stack([u, v, z], axis=-1)


# Dataset camera presets (reference importers.py:199, 553, 891).
ICVL_CAMERA = Camera(fx=241.42, fy=241.42, ux=160.0, uy=120.0, width=320, height=240)
MSRA15_CAMERA = Camera(
    fx=241.42, fy=241.42, ux=160.0, uy=120.0, flip_y=True, width=320, height=240
)
NYU_CAMERA = Camera(
    fx=588.03, fy=587.07, ux=320.0, uy=240.0, flip_y=True, width=640, height=480
)

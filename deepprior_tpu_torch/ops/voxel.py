"""V2V-PoseNet's inputs, targets and decode (models/v2v.py), as tensor code
on the crops' device.

A crop (ops/crop.py: a metric cube about the CoM, depth normalized to
[-1, 1]) becomes an occupancy grid of G^3 voxels of edge s = cube_z / V
(G = 88, V = 96 published), centred on the CoM c (mm); a joint becomes a
Gaussian over the G/2 grid of the network's output, and an output heatmap's
argmax goes back to mm.  The labels are normalized by cube_z / 2 on every
axis (ops/augment.py), so one edge serves the three axes.

- ``voxelize``: every crop pixel whose normalized depth d lies strictly
  inside (-1, 1) (the cube's faces are background) is back-projected:
  z = d cube_z / 2 + c_z, its centre (u + 0.5, v + 0.5) through the crop
  transform's inverse to the frame, then ``Camera.img_to_3d`` at z
  (``Camera.depth_to_pcl``'s convention).  Voxel floor((p - c) / s + V / 2)
  - (V - G) / 2 is set to 1 where it lies in the grid.
- ``heatmap_targets``: exp(-|g - t|^2 / (2 sigma^2)) over the integer grid
  g of [0, G/2)^3, t = ((p - c) / s + G/2 - 1) / 2 = (V/2 labels_norm + G/2
  - 1) / 2, the centre of p's voxel pair at half resolution.
- ``decode_heatmaps``: the argmax voxel i of each joint's heatmap, to
  p = c + (2 i - (G/2 - 1)) s: the inverse of the targets' centre.
- ``heatmap_loss``: the squared error summed over joints and voxels, mean
  over the batch (the paper's loss).

No host sync and no boolean-mask indexing: pixels outside the grid scatter
into one spare slot past its end, which is dropped.  Axes 2-4 of a grid
and a heatmap are x, y, z.  A tensor is divided by a tensor, or by 2 (on
CUDA, PyTorch multiplies by the reciprocal of a Python number, which is
exact only for a power of two).
"""

from __future__ import annotations

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.geometry import inv3x3


def voxel_edge(cube, cube_voxels: int):
    """(B,) mm: the edge of a voxel, cube_z / cube_voxels."""
    z = cube[:, 2]
    return z / torch.full_like(z, float(cube_voxels))


def voxelize(crops, com, cube, m, camera: Camera, grid: int = 88, cube_voxels: int = 96):
    """Normalized crops (B, H, W), their CoMs (B, 3) in image coords
    (u, v, d), cubes (B, 3) mm and crop transforms (B, 3, 3) -> the occupancy
    (B, grid, grid, grid) float32, 1 where a point of the crop falls."""
    b, h, w = crops.shape
    dev = crops.device
    com3d = camera.img_to_3d(com)
    z = crops * (cube[:, 2] / 2.0)[:, None, None] + com[:, 2, None, None]
    minv = inv3x3(m)

    def row(i):
        return minv[:, i, 0, None, None], minv[:, i, 1, None, None], minv[:, i, 2, None, None]

    uc = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + 0.5
    vc = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + 0.5
    (a, bb, c), (d, e, f), (g, k, l) = row(0), row(1), row(2)
    hom = (g * uc + k * vc) + l
    u = ((a * uc + bb * vc) + c) / hom
    v = ((d * uc + e * vc) + f) / hom
    pts = camera.img_to_3d(torch.stack(torch.broadcast_tensors(u, v, z), dim=-1))
    q = (pts - com3d[:, None, None, :]) / voxel_edge(cube, cube_voxels)[:, None, None, None]
    idx = (torch.floor(q + cube_voxels / 2.0) - (cube_voxels - grid) // 2).to(torch.int64)
    inside = ((idx >= 0) & (idx < grid)).all(dim=-1) & (crops > -1.0) & (crops < 1.0)
    flat = (idx[..., 0] * grid + idx[..., 1]) * grid + idx[..., 2]
    flat = torch.where(inside, flat, grid ** 3).reshape(b, -1)
    vox = torch.zeros((b, grid ** 3 + 1), dtype=torch.float32, device=dev)
    vox.scatter_(1, flat, 1.0)
    return vox[:, :-1].reshape(b, grid, grid, grid)


def heatmap_targets(labels_norm, grid: int = 88, cube_voxels: int = 96, sigma: float = 1.7):
    """Labels (B, J, 3) normalized by cube_z / 2, CoM-centred -> heatmaps
    (B, J, grid/2, grid/2, grid/2) float32, each joint's Gaussian of
    ``sigma`` output voxels."""
    heat = grid // 2
    t = (labels_norm * (cube_voxels / 2.0) + (heat - 1)) / 2.0
    g = torch.arange(heat, dtype=torch.float32, device=labels_norm.device)
    tx, ty, tz = (t[..., i, None, None, None] for i in range(3))
    d2 = (torch.square(g[:, None, None] - tx) + torch.square(g[None, :, None] - ty)) \
        + torch.square(g[None, None, :] - tz)
    two_var = torch.full((), 2.0 * sigma * sigma, device=d2.device)
    return torch.exp(-d2 / two_var)


def decode_heatmaps(heatmaps, com3d, cube, cube_voxels: int = 96):
    """Heatmaps (B, J, n, n, n), the CoMs (B, 3) mm and cubes (B, 3) -> the
    joints (B, J, 3) mm at the centres of the argmax voxels."""
    b, j, n = heatmaps.shape[:3]
    i = torch.argmax(heatmaps.reshape(b, j, -1), dim=-1)
    ijk = torch.stack([i // (n * n), (i // n) % n, i % n], dim=-1).to(torch.float32)
    edge = voxel_edge(cube, cube_voxels)[:, None, None]
    return com3d[:, None, :] + (2.0 * ijk - (n - 1)) * edge


def heatmap_loss(out, target):
    """The squared error summed over joints and voxels, mean over the batch."""
    return torch.mean(torch.sum(torch.square(out - target).flatten(1), dim=1))

"""The plain reference of serving: raw frames and CoMs -> joints in mm.

clamp -> nearest cube crop normalized to [-1, 1] -> the network ->
PCA decode -> pose * cube_z / 2 + the CoM's metric position.  Float32,
TF32 off, in blocks of rows so that it fits beside nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import geometry as G
from bench_torch.reference import nets

BLOCK = 64


def pose_from_frames(cfg, weights, comp, mean, depth, com, cube):
    """Tensors on one device: depth (B, H, W) raw mm, com (B, 3), cube
    (B, 3) -> joints (B, J, 3) mm."""
    cam = G.Camera.of(cfg)
    dc, _, _ = G.clamp_depth(depth)
    crops, _ = G.normalized_crop(dc, com, cube, cam.fx, cam.fy)
    with nets.plain_float32():
        emb = nets.NETS[cfg["model"]["family"]](weights, crops[:, None])
    pose = nets.pca_decode(emb, comp, mean).reshape(len(com), -1, 3)
    return pose * (cube[:, 2] / 2.0)[:, None, None] + cam.img_to_3d(com)[:, None, :]


@torch.no_grad()
def joints(cfg, weights, comp, mean, depth, com, device) -> np.ndarray:
    """numpy depth (N, H, W) and com (N, 3) with the configuration's cube ->
    (N, J, 3) joints as numpy, computed on ``device`` in blocks."""
    out = []
    for s in range(0, len(depth), BLOCK):
        d = torch.as_tensor(depth[s:s + BLOCK], device=device)
        c = torch.as_tensor(com[s:s + BLOCK], device=device)
        cube = torch.tensor(cfg["cube_mm"], dtype=torch.float32, device=device).expand(len(c), 3)
        out.append(pose_from_frames(cfg, weights, comp, mean, d, c, cube).cpu().numpy())
    return np.concatenate(out)

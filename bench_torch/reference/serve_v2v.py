"""The plain reference of V2V-PoseNet's serving: raw frames and CoMs -> the
occupancy grids, the heatmaps and the joints in mm.

clamp -> nearest cube crop normalized to [-1, 1] and its crop transform
(``reference/geometry.py``) -> the occupancy grid (``reference/v2v.py``'s
voxelize) -> the network in eval mode, BatchNorm by its running
statistics (``reference/v2v.py``) -> the argmax decode about the CoM -> the
relative flip of a mirrored row's x -> + the CoM's metric position.  A
mirrored row's grid is flipped along x before the network.  Float32, TF32
off, in blocks of rows.  Nothing here imports the program.

``calibrate`` sets the running statistics a cell serves with: the mean of
each BatchNorm's batch statistics over training-mode passes of the
reference network, without gradients, over grids of the cell's frames.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench_torch.reference import geometry as G
from bench_torch.reference import v2v

BLOCK = 8


def _pin(cam: G.Camera):
    return cam.fx, cam.fy, cam.ux, cam.uy, cam.flip_y


def grids(cfg, depth, com, cube):
    """Tensors on one device: depth (B, H, W) raw mm, com (B, 3) image
    coords, cube (B, 3) mm -> the occupancy grids (B, G, G, G)."""
    spec, cam = cfg["model"], G.Camera.of(cfg)
    dc, _, _ = G.clamp_depth(depth)
    hw = int(cfg["input_hw"])
    crops, m = G.normalized_crop(dc, com, cube, cam.fx, cam.fy, (hw, hw))
    return v2v.voxelize(crops, com, cube, m, _pin(cam), spec["grid"], spec["cube_voxels"])


def pipeline(cfg, weights, depth, com, cube, mirror=None, grid=None):
    """Tensors on one device: depth, com and cube as ``grids`` takes them,
    mirror (B,) bool or None; ``grid`` (B, G, G, G), when given, is fed to
    the network in place of the reference's own.  Returns (the grid before
    the mirror, heatmaps (B, J, n, n, n), joints (B, J, 3) mm)."""
    spec, cam = cfg["model"], G.Camera.of(cfg)
    if grid is None:
        grid = grids(cfg, depth, com, cube)
    x = grid if mirror is None else torch.where(mirror[:, None, None, None], grid.flip(1), grid)
    with v2v.plain_float32():
        heat = v2v.net(weights, x[:, None], train=False)
    rel = v2v.decode_heatmaps(heat, torch.zeros_like(cube), cube, spec["cube_voxels"])
    if mirror is not None:
        sign = torch.where(mirror, -1.0, 1.0)[:, None]
        rel = torch.stack([rel[..., 0] * sign, rel[..., 1], rel[..., 2]], dim=-1)
    return grid, heat, rel + cam.img_to_3d(com)[:, None, :]


@contextlib.contextmanager
def _batch_stats(into: dict):
    """``reference/v2v.py``'s network with each training-mode BatchNorm's
    batch mean and variance appended to ``into[its prefix]``."""
    plain = v2v._bn

    def bn(w, p, x, train):
        if train:
            mean = x.mean(dim=(0, 2, 3, 4))
            var = torch.square(x - mean[:, None, None, None]).mean(dim=(0, 2, 3, 4))
            into.setdefault(p, []).append((mean, var))
        return plain(w, p, x, train)

    v2v._bn = bn
    try:
        yield
    finally:
        v2v._bn = plain


@torch.no_grad()
def calibrate(cfg, weights: dict, depth, com, device) -> dict:
    """``weights`` with every BatchNorm's running_mean and running_var set
    to the mean of its batch statistics over training-mode passes of
    BLOCK frames at a time over numpy depth (N, H, W) and com (N, 3), with
    the configuration's cube; the other leaves as given."""
    seen: dict = {}
    cube = torch.tensor(cfg["cube_mm"], dtype=torch.float32, device=device)
    with _batch_stats(seen), v2v.plain_float32():
        for s in range(0, len(depth) - BLOCK + 1, BLOCK):
            d = torch.as_tensor(depth[s:s + BLOCK], device=device)
            c = torch.as_tensor(com[s:s + BLOCK], device=device)
            x = grids(cfg, d, c, cube.expand(len(c), 3))
            v2v.net(weights, x[:, None], train=True)
    out = dict(weights)
    for p, stats in seen.items():
        out[p + ".running_mean"] = torch.stack([m for m, _ in stats]).mean(dim=0)
        out[p + ".running_var"] = torch.stack([v for _, v in stats]).mean(dim=0)
    return out


@torch.no_grad()
def readings(cfg, weights, depth, com, prog_grid, prog_heat, answered, clear_margin,
             device) -> dict:
    """The numbers ``correct`` is decided on, of numpy depth (N, H, W) and
    com (N, 3) with the configuration's cube and no mirror, computed on
    ``device`` in blocks: the program's grids (N, G, G, G) and heatmaps
    (N, J, n, n, n) and its answered joints (N, J, 3) against the
    reference's.

    grid_mismatch: the voxels where the program's grid differs from the
    reference's own, over the voxels set in either (almost every voxel of
    a grid is empty: a share of all of them would hide a lost hand);
    heatmap_rel: the worst over frames of
    max |h - h_ref| / max |h_ref|, the reference fed the program's grid;
    joints_mm: the worst joint error against the reference's decode of
    h_ref over the joints whose top voxel beats the runner-up by more
    than ``clear_margin`` x max |h_ref| of the frame (``joints_skipped``
    counts the others: with random weights a close argmax can change on
    rounding, as a sampled token can)."""
    differ, union, rel, worst, skipped = 0, 0, 0.0, 0.0, 0
    for s in range(0, len(depth), BLOCK):
        d = torch.as_tensor(depth[s:s + BLOCK], device=device)
        c = torch.as_tensor(com[s:s + BLOCK], device=device)
        cube = torch.tensor(cfg["cube_mm"], dtype=torch.float32, device=device).expand(len(c), 3)
        grid = torch.as_tensor(prog_grid[s:s + BLOCK], device=device).float()
        own = grids(cfg, d, c, cube)
        differ += int((own != grid).sum())
        union += int(((own != 0) | (grid != 0)).sum())
        _, h_ref, joints = pipeline(cfg, weights, d, c, cube, grid=grid)
        heat = torch.as_tensor(prog_heat[s:s + BLOCK], device=device).float()
        scale = h_ref.abs().flatten(1).amax(dim=1)
        rel = max(rel, float(((heat - h_ref).abs().flatten(1).amax(dim=1) / scale).max()))
        top = torch.topk(h_ref.flatten(2), 2, dim=2).values
        clear = (top[..., 0] - top[..., 1]) > clear_margin * scale[:, None]
        skipped += int((~clear).sum())
        err = (torch.as_tensor(answered[s:s + BLOCK], device=device) - joints).abs().amax(dim=2)
        if bool(clear.any()):
            worst = max(worst, float(err[clear].max()))
    return {"grid_mismatch": differ / max(1, union), "heatmap_rel": rel, "joints_mm": worst,
            "joints_skipped": skipped, "joints_checked": int(np.prod(answered.shape[:2]))}

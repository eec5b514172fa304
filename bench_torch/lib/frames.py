"""The benchmark's depth frames: a kinematic hand of 14 joints rendered as
depth spheres into the configuration's camera, drawn from a seed.

A copy of the port's synthetic renderer (deepprior_tpu_torch/data/
synthetic.py: ``synthetic_hand``, ``render_depth``, ``make_depth_frame``),
kept here so that a change to the program cannot change the traffic.  One
frame takes about 2 ms on the host.  The same seed gives the same frames.
"""

from __future__ import annotations

import numpy as np


def img_to_3d(cam: dict, uvd):
    uvd = np.asarray(uvd, np.float32)
    u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    x = (u - cam["ux"]) * d / cam["fx"]
    y = ((cam["uy"] - v) if cam["flip_y"] else (v - cam["uy"])) * d / cam["fy"]
    return np.stack([x, y, d], axis=-1)


def three_d_to_img(cam: dict, xyz):
    xyz = np.asarray(xyz, np.float32)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    safe_z = np.where(z == 0.0, 1.0, z)
    u = x / safe_z * cam["fx"] + cam["ux"]
    if cam["flip_y"]:
        v = cam["uy"] - y / safe_z * cam["fy"]
    else:
        v = y / safe_z * cam["fy"] + cam["uy"]
    u = np.where(z == 0.0, cam["ux"], u)
    v = np.where(z == 0.0, cam["uy"], v)
    return np.stack([u, v, z], axis=-1)


def synthetic_hand(rng, num_joints=14, spread_mm=80.0):
    """(pose (J, 3) CoM-centred mm, fill points (K, 3), fill radii (K,)):
    a palm, a wrist and five finger chains, with a random in-plane
    orientation, a small tilt and per-finger flexion."""
    n_fingers = 5
    palm_r = spread_mm * 0.45
    alpha = np.deg2rad(rng.uniform(-180.0, 180.0))
    tilt_x, tilt_y = rng.uniform(-0.35, 0.35, 2)
    n_chain = num_joints - 2
    per_finger = [n_chain // n_fingers] * n_fingers
    for i in range(n_chain - sum(per_finger)):
        per_finger[i] += 1

    def rot_inplane(p):
        c, s = np.cos(alpha), np.sin(alpha)
        return np.array([c * p[0] - s * p[1], s * p[0] + c * p[1], p[2]])

    def tilt(p):
        cx, sx = np.cos(tilt_x), np.sin(tilt_x)
        y, z = p[1] * cx - p[2] * sx, p[1] * sx + p[2] * cx
        cy, sy = np.cos(tilt_y), np.sin(tilt_y)
        x, z = p[0] * cy + z * sy, -p[0] * sy + z * cy
        return np.array([x, y, z])

    joints = [np.zeros(3)]
    fills = [(np.zeros(3), palm_r * 0.9)]
    wrist = tilt(rot_inplane(np.array([0.0, palm_r * 1.4, 0.0])))
    joints.append(wrist)
    fills.append((wrist * 0.6, palm_r * 0.6))
    fan = np.deg2rad(np.array([-55.0, -25.0, 0.0, 25.0, 55.0]))
    seg_len = spread_mm * 0.45
    for f in range(n_fingers):
        nj = per_finger[f]
        if nj == 0:
            continue
        theta = fan[f]
        d_plane = np.array([np.sin(theta), -np.cos(theta), 0.0])
        flex = rng.uniform(0.0, np.deg2rad(75.0))
        pos = d_plane * palm_r
        seg = seg_len * (0.8 if f in (0, 4) else 1.0) / max(nj, 1)
        bend = 0.0
        prev = tilt(rot_inplane(pos))
        for _ in range(nj):
            bend += flex / max(nj, 1)
            step = d_plane * seg * np.cos(bend) + np.array([0, 0, seg * np.sin(bend)])
            pos = pos + step
            cur = tilt(rot_inplane(pos))
            joints.append(cur)
            fills.append(((prev + cur) / 2.0, spread_mm * 0.12))
            prev = cur
    pose = np.stack(joints[:num_joints]).astype(np.float32)
    fill_pts = np.stack([p for p, _ in fills]).astype(np.float32)
    fill_radii = np.array([r for _, r in fills], np.float32)
    return pose, fill_pts, fill_radii


def render_depth(cam: dict, com3d, pts, radii):
    """Points as depth spheres into an (H, W) map, background 0."""
    h, w = cam["height"], cam["width"]
    dpt = np.full((h, w), np.inf, np.float32)
    pts3d = np.asarray(pts) + com3d[None, :]
    uvd = three_d_to_img(cam, pts3d)
    for (u, v, d), r in zip(uvd, radii):
        if d <= 0:
            continue
        r_px = r * cam["fx"] / d
        x0, x1 = max(int(u - r_px) - 1, 0), min(int(u + r_px) + 2, w)
        y0, y1 = max(int(v - r_px) - 1, 0), min(int(v + r_px) + 2, h)
        if x0 >= x1 or y0 >= y1:
            continue
        cols = np.arange(x0, x1, dtype=np.float32)[None, :]
        rows = np.arange(y0, y1, dtype=np.float32)[:, None]
        dist2 = (cols - u) ** 2 + (rows - v) ** 2
        mask = dist2 <= r_px ** 2
        bulge = r * np.sqrt(np.clip(1.0 - dist2 / max(r_px ** 2, 1e-6), 0, 1))
        cand = (d - bulge).astype(np.float32)
        win = dpt[y0:y1, x0:x1]
        dpt[y0:y1, x0:x1] = np.where(mask & (cand < win), cand, win)
    dpt[~np.isfinite(dpt)] = 0.0
    return dpt


def render_pool(cfg: dict, rng, n: int):
    """``n`` frames of the configuration's camera: (depth (n, H, W) float32
    mm, com (n, 3) float32 image coordinates of the palm, joints (n, J, 3)
    float32 mm relative to that CoM's metric position)."""
    cam = cfg["camera"]
    lo, hi = cfg["frames"]["com_depth_mm"]
    nj = cfg["num_joints"]
    depth = np.empty((n, cam["height"], cam["width"]), np.float32)
    com = np.empty((n, 3), np.float32)
    joints = np.empty((n, nj, 3), np.float32)
    margin = 90.0
    for i in range(n):
        d = rng.uniform(lo, hi)
        u = rng.uniform(margin, cam["width"] - margin)
        v = rng.uniform(margin, cam["height"] - margin)
        com3d = img_to_3d(cam, np.array([u, v, d], np.float32))
        pose, fill_pts, fill_radii = synthetic_hand(rng, nj)
        pts = np.concatenate([pose, fill_pts], axis=0)
        radii = np.concatenate([np.full(len(pose), 14.0, np.float32), fill_radii])
        depth[i] = render_depth(cam, com3d, pts, radii)
        gt3d = pose + com3d[None, :]
        com[i] = three_d_to_img(cam, gt3d)[0]
        joints[i] = gt3d - img_to_3d(cam, com[i])[None, :]
    return depth, com, joints

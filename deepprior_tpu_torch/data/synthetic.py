"""Synthetic depth frames of a parametric hand.

Counterpart of deepprior_tpu/data/synthetic.py: a palm sphere and finger
capsules rendered into a depth map (numpy), cropped like an importer.
``make_depth_frame`` and ``make_frame`` draw from ``rng`` in the same
order as the JAX package's ``make_frame``, so one seed gives the same
frames in both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.data.basetypes import DepthFrame, ImageSequence
from deepprior_tpu_torch.geometry import transform_points_2d_np
from deepprior_tpu_torch.ops.crop import clamp_depth, crop3d


def synthetic_hand(
    rng: np.random.Generator, num_joints: int = 14, spread_mm: float = 80.0
):
    """Kinematic synthetic hand with consistent topology.

    Joint 0 is the palm centre (the crop joint); joint 1 the wrist; the
    remaining joints distribute over 5 finger chains fanned from the palm.
    Per-frame randomness: in-plane orientation, a small 3D tilt and
    per-finger flexion.

    Returns (pose (J, 3) float32 CoM-centred mm,
             fill_pts (K, 3) extra render points (bones/palm),
             fill_radii (K,)).
    """
    n_fingers = 5
    palm_r = spread_mm * 0.45
    alpha = np.deg2rad(rng.uniform(-180.0, 180.0))  # in-plane orientation
    tilt_x, tilt_y = rng.uniform(-0.35, 0.35, 2)  # out-of-plane tilt

    # distribute joints: [palm, wrist, fingers...]
    n_chain = num_joints - 2
    per_finger = [n_chain // n_fingers] * n_fingers
    for i in range(n_chain - sum(per_finger)):
        per_finger[i] += 1

    def rot_inplane(p):
        c, s = np.cos(alpha), np.sin(alpha)
        return np.array([c * p[0] - s * p[1], s * p[0] + c * p[1], p[2]])

    def tilt(p):
        # small rotations about x then y
        cx, sx = np.cos(tilt_x), np.sin(tilt_x)
        y, z = p[1] * cx - p[2] * sx, p[1] * sx + p[2] * cx
        cy, sy = np.cos(tilt_y), np.sin(tilt_y)
        x, z = p[0] * cy + z * sy, -p[0] * sy + z * cy
        return np.array([x, y, z])

    joints = [np.zeros(3)]  # palm centre
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
        # finger base direction in the palm plane (pointing "up" = -y)
        theta = fan[f]
        d_plane = np.array([np.sin(theta), -np.cos(theta), 0.0])
        flex = rng.uniform(0.0, np.deg2rad(75.0))  # per-finger flexion
        pos = d_plane * palm_r
        seg = seg_len * (0.8 if f in (0, 4) else 1.0) / max(nj, 1)
        bend = 0.0
        prev = tilt(rot_inplane(pos))
        for k in range(nj):
            bend += flex / max(nj, 1)
            step = d_plane * seg * np.cos(bend) + np.array([0, 0, seg * np.sin(bend)])
            pos = pos + step
            cur = tilt(rot_inplane(pos))
            joints.append(cur)
            # bone fill between prev and cur
            fills.append(((prev + cur) / 2.0, spread_mm * 0.12))
            prev = cur

    pose = np.stack(joints[:num_joints]).astype(np.float32)
    fill_pts = np.stack([p for p, _ in fills]).astype(np.float32)
    fill_radii = np.array([r for _, r in fills], np.float32)
    return pose, fill_pts, fill_radii


def synthetic_hand_pose(
    rng: np.random.Generator, num_joints: int = 14, spread_mm: float = 80.0
) -> np.ndarray:
    """CoM-centred pose of a random kinematic hand (labels only)."""
    return synthetic_hand(rng, num_joints, spread_mm)[0]


def render_depth(
    camera: Camera,
    com3d: np.ndarray,
    pose3d: np.ndarray,
    radius_mm=14.0,
    background: float = 0.0,
) -> np.ndarray:
    """Render points as depth spheres into a (H, W) map.

    radius_mm: scalar or per-point array; depth = nearest sphere surface.
    """
    h, w = camera.height, camera.width
    dpt = np.full((h, w), np.inf, np.float32)
    pts3d = np.asarray(pose3d) + com3d[None, :]
    radii = np.broadcast_to(np.asarray(radius_mm, np.float32), (len(pts3d),))
    uvd = camera.three_d_to_img_np(pts3d)
    for (u, v, d), r in zip(uvd, radii):
        if d <= 0:
            continue
        r_px = r * camera.fx / d
        # only touch the sphere's bounding window
        x0 = max(int(u - r_px) - 1, 0)
        x1 = min(int(u + r_px) + 2, w)
        y0 = max(int(v - r_px) - 1, 0)
        y1 = min(int(v + r_px) + 2, h)
        if x0 >= x1 or y0 >= y1:
            continue
        cols = np.arange(x0, x1, dtype=np.float32)[None, :]
        rows = np.arange(y0, y1, dtype=np.float32)[:, None]
        dist2 = (cols - u) ** 2 + (rows - v) ** 2
        mask = dist2 <= r_px**2
        # sphere surface: nearer toward the centre
        bulge = r * np.sqrt(np.clip(1.0 - dist2 / max(r_px**2, 1e-6), 0, 1))
        cand = (d - bulge).astype(np.float32)
        win = dpt[y0:y1, x0:x1]
        dpt[y0:y1, x0:x1] = np.where(mask & (cand < win), cand, win)
    dpt[~np.isfinite(dpt)] = background
    return dpt


def _render_frame(camera, rng, num_joints, com_depth_range):
    """Draw a hand and render it: (dpt_full (H, W), com3d (3,), pose3d
    (J, 3) CoM-centred), drawing from ``rng`` in the JAX ``make_frame``'s
    order."""
    d = rng.uniform(*com_depth_range)
    margin = 90.0
    u = rng.uniform(margin, camera.width - margin)
    v = rng.uniform(margin, camera.height - margin)
    com3d = camera.img_to_3d_np(np.array([u, v, d], np.float32))
    pose3d, fill_pts, fill_radii = synthetic_hand(rng, num_joints)

    all_pts = np.concatenate([pose3d, fill_pts], axis=0)
    all_radii = np.concatenate(
        [np.full(len(pose3d), 14.0, np.float32), fill_radii]
    )
    return render_depth(camera, com3d, all_pts, all_radii), com3d, pose3d


def make_depth_frame(
    camera: Camera,
    rng: np.random.Generator,
    num_joints: int = 14,
    com_depth_range: Tuple[float, float] = (500.0, 900.0),
):
    """One raw synthetic frame and its hand CoM.

    Returns (dpt_full (H, W) float32 mm, com (3,) float32 image coords):
    the ``extraData["dpt_full"]`` and ``com`` of the JAX package's
    ``make_frame(camera, rng, num_joints, com_depth_range=...)`` with
    docom=False, for the same rng state.
    """
    dpt_full, com3d, pose3d = _render_frame(camera, rng, num_joints,
                                            com_depth_range)
    # the crop centre is joint 0 (the palm) projected back to the image
    gtorig = camera.three_d_to_img_np(pose3d + com3d[None, :])
    return dpt_full, np.asarray(gtorig[0], np.float32)


def make_frame(
    camera: Camera,
    rng: np.random.Generator,
    num_joints: int = 14,
    cube: Tuple[float, float, float] = (250.0, 250.0, 250.0),
    com_depth_range: Tuple[float, float] = (500.0, 900.0),
    dsize: Tuple[int, int] = (128, 128),
    docom: bool = False,
) -> DepthFrame:
    """One synthetic frame: render, crop and annotate like an importer.

    The JAX ``make_frame``'s frame for the same rng state: the crop is
    the port's clamp_depth + crop3d on a one-frame CPU tensor, which
    equals the numpy ``HandCropper.crop_area_3d`` the JAX package uses
    bit for bit (tests/test_torch_crop.py).  ``docom`` recentres the CoM
    inside the cube first, as the JAX package does, through the numpy
    ``HandCropper`` (data/detector_np.py)."""
    dpt_full, com3d, pose3d = _render_frame(camera, rng, num_joints,
                                            com_depth_range)
    gt3d_orig = pose3d + com3d[None, :]
    gtorig = camera.three_d_to_img_np(gt3d_orig)
    if docom:
        from deepprior_tpu_torch.data.detector_np import HandCropper

        crop, m, com_used = HandCropper(dpt_full, camera).crop_area_3d(
            com=gtorig[0], size=cube, dsize=dsize, docom=True)
        crop = torch.from_numpy(crop)[None]
    else:
        com_used = np.asarray(gtorig[0], np.float32).copy()
        clamped, _, _ = clamp_depth(torch.from_numpy(dpt_full)[None])
        crop, m = crop3d(clamped, torch.from_numpy(com_used)[None], cube,
                         camera.fx, camera.fy, dsize)
        m = m[0].numpy()
    com_used = np.asarray(com_used, np.float32)
    com3d_used = camera.img_to_3d_np(com_used)
    gtcrop = transform_points_2d_np(gtorig, m)
    return DepthFrame(
        dpt=crop[0].numpy(),
        gtorig=gtorig.astype(np.float32),
        gtcrop=gtcrop.astype(np.float32),
        T=m.astype(np.float32),
        gt3Dorig=gt3d_orig.astype(np.float32),
        gt3Dcrop=(gt3d_orig - com3d_used[None, :]).astype(np.float32),
        com=com_used,
        fileName=f"synthetic_{num_joints}j",
        extraData={"dpt_full": dpt_full},
    )


def make_sequence(
    camera: Camera,
    num_frames: int,
    num_joints: int = 14,
    cube: Tuple[float, float, float] = (250.0, 250.0, 250.0),
    seed: int = 23455,
    name: str = "train",
    docom: bool = False,
    keep_full: bool = False,
    dsize: Tuple[int, int] = (128, 128),
) -> ImageSequence:
    """A synthetic ImageSequence shaped like an importer's output: the JAX
    ``make_sequence``'s frames for the same seed (without its on-disk
    cache), cropped to ``dsize``."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(num_frames):
        f = make_frame(camera, rng, num_joints, cube, dsize=dsize, docom=docom)
        if not keep_full:
            f = f._replace(extraData=None)
        frames.append(f)
    return ImageSequence(name=name, data=frames, config={"cube": cube})

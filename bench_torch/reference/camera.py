"""The plain reference of the camera loop at batch 1: detection on the raw
frame, the ScaleNet CoM refinement on the clamped frame, then the pose.
Float32, TF32 off; one frame at a time."""

from __future__ import annotations

import torch

from bench_torch.reference import geometry as G
from bench_torch.reference import nets
from bench_torch.reference.serve import pose_from_frames


def refine(cfg, weights, dpt, com, cube):
    """The CNN refinement: ScaleNet reads the crop around ``com`` of the
    clamped frames ``dpt`` and moves the CoM by its normalized 3D offset
    times cube_z / 2; a CoM that collapses to zero keeps the old one."""
    cam = G.Camera.of(cfg)
    crops, _ = G.normalized_crop(dpt, com, cube, cam.fx, cam.fy)
    with nets.plain_float32():
        offset = nets.scalenet(weights, crops[:, None]) * (cube[:, 2:3] / 2.0)
    new = cam.three_d_to_img(cam.img_to_3d(com) + offset)
    bad = torch.isclose(new, torch.zeros_like(new)).all(dim=-1, keepdim=True)
    return torch.where(bad, com, new)


@torch.no_grad()
def frame_outputs(cfg, pose_w, refine_w, comp, mean, frame, device):
    """(detected CoM, refined CoM, joints) of one raw frame, as numpy; the
    refined CoM and the joints are None where nothing is detected."""
    cam = G.Camera.of(cfg)
    fr = torch.as_tensor(frame, device=device)[None]
    cube = torch.tensor(cfg["cube_mm"], dtype=torch.float32, device=device)[None]
    det = G.detect(fr, cube, cam.fx, cam.fy)
    if torch.allclose(det, torch.zeros_like(det)):
        return det[0].cpu().numpy(), None, None
    com = refine(cfg, refine_w, G.clamp_depth(fr)[0], det, cube)
    joints = pose_from_frames(cfg, pose_w, comp, mean, fr, com, cube)
    return det[0].cpu().numpy(), com[0].cpu().numpy(), joints[0].cpu().numpy()

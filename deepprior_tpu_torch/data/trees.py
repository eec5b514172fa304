"""Seeded dataset trees in the real file formats of ICVL, NYU and MSRA15.

Frames are the synthetic hands of ``data/synthetic.py`` rendered at each
dataset's camera and frame size; the labels are written as each dataset
stores them, so the importers read the trees exactly as they read the
real datasets:

- MSRA15: <root>/P<i>/<gesture>/joint.txt (the frame count, then 21
  joints' x y z per line, z negated) and NNNNNN_depth.bin (header w, h,
  left, top, right, bottom as int32, then the float32 bounding box of the
  hand's pixels);
- ICVL:   <root>/<seq>.txt ("<relpath> u v d" x 16 per line) and 16-bit
  grayscale PNGs under <root>/Depth/;
- NYU:    <root>/<seq>/joint_data.mat (joint_uvd, joint_xyz: (1, N, 36,
  3)) and depth_1_NNNNNNN.png, the depth packed as G<<8 | B.

The PNG trees need Pillow.  Usage: ``write_msra15_tree(root, frames=256)``
and the like; each returns {sequence: [(gtorig, gt3Dorig), ...]} of what
it wrote.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Sequence

import numpy as np

from deepprior_tpu_torch.camera import ICVL_CAMERA, MSRA15_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.data.importers import _pil_image
from deepprior_tpu_torch.data.synthetic import _render_frame


def _frame(camera, rng, num_joints, depths):
    """(depth (H, W) float32, gtorig (J, 3), gt3Dorig (J, 3))."""
    dpt, com3d, pose3d = _render_frame(camera, rng, num_joints, depths)
    gt3d = (pose3d + com3d[None, :]).astype(np.float32)
    return dpt, camera.three_d_to_img_np(gt3d).astype(np.float32), gt3d


def write_msra15_tree(root: str, subjects: Sequence[str] = ("P0",), frames: int = 4,
                      seed: int = 0, gesture: str = "1", depths=(300.0, 500.0)):
    """``frames`` frames of one gesture for each subject."""
    rng = np.random.default_rng(seed)
    truths: Dict[str, list] = {}
    for subj in subjects:
        gdir = os.path.join(root, subj, gesture)
        os.makedirs(gdir, exist_ok=True)
        lines, truths[subj] = [str(frames)], []
        for i in range(frames):
            dpt, gtorig, gt3d = _frame(MSRA15_CAMERA, rng, 21, depths)
            stored = gt3d.copy()
            stored[:, 2] *= -1.0  # the importer negates z (importers.py:688)
            lines.append(" ".join(f"{v:.4f}" for v in stored.reshape(-1)))
            rows, cols = np.nonzero(dpt)
            t, b, l, r = rows.min(), rows.max() + 1, cols.min(), cols.max() + 1
            with open(os.path.join(gdir, f"{i:06d}_depth.bin"), "wb") as f:
                f.write(struct.pack("<6i", dpt.shape[1], dpt.shape[0], l, t, r, b))
                dpt[t:b, l:r].astype(np.float32).tofile(f)
            truths[subj].append((gtorig, gt3d))
        with open(os.path.join(gdir, "joint.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return truths


def write_icvl_tree(root: str, seqs: Dict[str, int], seed: int = 0,
                    subseq: str = "seq1", depths=(450.0, 700.0)):
    """{sequence name: frame count}; every frame under Depth/<subseq>/."""
    image = _pil_image()
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Depth", subseq), exist_ok=True)
    truths: Dict[str, list] = {}
    for seq, n in seqs.items():
        lines, truths[seq] = [], []
        for i in range(n):
            dpt, gtorig, gt3d = _frame(ICVL_CAMERA, rng, 16, depths)
            rel = f"{subseq}/{seq}_{i:04d}.png"
            image.fromarray(dpt.astype(np.uint16)).save(os.path.join(root, "Depth", rel))
            lines.append(rel + " " + " ".join(f"{v:.4f}" for v in gtorig.reshape(-1)))
            truths[seq].append((gtorig, gt3d))
        with open(os.path.join(root, f"{seq}.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return truths


def write_nyu_tree(root: str, seqs: Dict[str, int], seed: int = 0,
                   depths=(550.0, 800.0)):
    """{sequence name: frame count}, 36 joints a frame."""
    import scipy.io

    image = _pil_image()
    rng = np.random.default_rng(seed)
    truths: Dict[str, list] = {}
    for seq, n in seqs.items():
        os.makedirs(os.path.join(root, seq), exist_ok=True)
        j2d, j3d = np.zeros((n, 36, 3)), np.zeros((n, 36, 3))
        truths[seq] = []
        for i in range(n):
            dpt, gtorig, gt3d = _frame(NYU_CAMERA, rng, 36, depths)
            d16 = dpt.astype(np.uint16)
            rgb = np.zeros(dpt.shape + (3,), np.uint8)
            rgb[..., 1] = d16 >> 8
            rgb[..., 2] = d16 & 0xFF
            image.fromarray(rgb).save(os.path.join(root, seq, f"depth_1_{i + 1:07d}.png"))
            j2d[i], j3d[i] = gtorig, gt3d
            truths[seq].append((gtorig, gt3d))
        scipy.io.savemat(os.path.join(root, seq, "joint_data.mat"),
                         {"joint_uvd": j2d[None], "joint_xyz": j3d[None]})
    return truths

"""CNN-based CoM refinement, the 'comref' detection mode.

Counterpart of deepprior_tpu/ops/refine_cnn.py (reference
handdetector.py:634-676): the crop around the current CoM is normalized to
[-1, 1], ScaleNet reads it and its /2 and /4 centre crops, and the
predicted normalized 3D offset (x cube_z/2) moves the CoM in metric space.
"""

from __future__ import annotations

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.ops.hopper_crop import hopper_normalized_crop
from deepprior_tpu_torch.train.trainer import float32_compute


class CNNComRefiner:
    """A trained ScaleNet (or any crop -> offset ``nn.Module``) as a batched
    CoM refiner.  The model runs on its own device and in eval mode; a
    float32 model computes in float32 on the card too (``float32_compute``:
    no TF32 convs).  The crop is the nearest crop: the kernel K1 on a CUDA
    device, its plain version on the CPU."""

    def __init__(self, model: torch.nn.Module, camera: Camera, dsize=(128, 128)):
        self.model = model.eval()
        self.camera = camera
        self.dsize = tuple(dsize)
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def __call__(self, dpt, com, cube):
        """dpt: (B, H, W) clamped depth; com: (B, 3); cube: (3,) or (B, 3).
        Returns the refined com (B, 3) in image coordinates; a refined CoM
        that collapses to zero keeps the old one (handdetector.py:521-523)."""
        cam, dev = self.camera, self.device
        dpt = torch.as_tensor(dpt, dtype=torch.float32, device=dev)
        com = torch.as_tensor(com, dtype=torch.float32, device=dev)
        cube = torch.as_tensor(cube, dtype=torch.float32, device=dev).expand(com.shape)
        crops, _ = hopper_normalized_crop(dpt, com, cube, cam.fx, cam.fy, self.dsize)
        with float32_compute():
            offset_norm = self.model(crops[:, None])  # (B, 3) normalized
        offset_mm = offset_norm * (cube[:, 2:3] / 2.0)
        new_com = cam.three_d_to_img(cam.img_to_3d(com) + offset_mm)
        bad = torch.isclose(new_com, torch.zeros_like(new_com)).all(dim=-1, keepdim=True)
        return torch.where(bad, com, new_com)

"""The fused inference pipeline: depth frames -> 3D joints, on one device.

Counterpart of deepprior_tpu/realtime/fused.py.  Per batch:

  clamp -> (optional CoM detection / iterative refinement) -> cube crop +
  normalize -> PoseRegNet -> (optional PCA decode) -> mirror / flip ->
  denormalize (pose * cube_z/2 + com3D)

On a CUDA device the crop and normalize are one launch of the hand-written
kernel (ops/hopper_crop.py): K1 for the nearest resize, K2 for 'linear',
with the clamp fused into it when there is no detection, and on the
clamped frame after it.  'nd_bilinear' has no kernel in either package and
runs the plain crop.  On the CPU every step is the plain PyTorch of
ops/crop.py and ops/com.py.  The pipeline runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.ops.com import detect_closest, refine_com_iterative
from deepprior_tpu_torch.ops.crop import RESIZE_METHODS, clamp_depth, normalized_crop
from deepprior_tpu_torch.ops.hopper_crop import hopper_normalized_crop
from deepprior_tpu_torch.prior import PCAPrior

_CROP_METHODS = ("auto", "pallas", "hopper", "gather", "onehot")


class FusedEstimator:
    """Applies the frame -> pose pipeline to batches.

    ``model`` is an ``nn.Module`` that holds its weights and maps
    (B, 1, dh, dw) crops to (B, out) embeddings or poses.  ``device``
    defaults to the model's; the model and prior move to it.

    crop_method: 'auto' takes the CUDA kernel on a CUDA device and the
    plain gather on the CPU; 'pallas' (the JAX package's name) and
    'hopper' name the kernel path; 'gather' and 'onehot' force the plain
    path.  min_depth_mm set the TPU kernel's window height and has no
    effect here.

    detect: find the CoM on the device (``ops.com.detect_closest``) and
    ignore the ``com`` passed in; refine_iters > 0: refine the passed CoM
    that many times (``refine_com_iterative``).  Both run on the clamped
    frames, with each image's clamp limits.

    resize: the reference's resize-method switch (handdetector.py:57-69),
    None/'nearest', 'linear' or 'nd_bilinear'.  One routing difference
    from the JAX estimator: it sends 'linear' to its XLA one-hot crop,
    while the kernel path here runs the cv2-linear kernel K2; both compute
    the same crop to float32 round-off.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        camera: Camera,
        cube=(250.0, 250.0, 250.0),
        prior: Optional[PCAPrior] = None,
        num_joints: Optional[int] = None,
        dsize=(128, 128),
        refine_iters: int = 0,
        detect: bool = False,
        crop_method: str = "auto",
        min_depth_mm: Optional[float] = None,
        resize: Optional[str] = None,
        device=None,
    ):
        if resize is not None and resize not in RESIZE_METHODS:
            raise ValueError(f"unknown resize method {resize!r}")
        if crop_method not in _CROP_METHODS:
            raise ValueError(f"unknown crop method {crop_method!r}")
        if device is None:
            device = next(model.parameters()).device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        self.model = model.to(self.device).eval()
        self.camera = camera
        self.cube = torch.as_tensor(cube, dtype=torch.float32, device=self.device)
        self.prior = None if prior is None else prior.to(self.device)
        self.num_joints = num_joints
        self.dsize = tuple(dsize)
        self.refine_iters = refine_iters
        self.detect = detect
        self.resize = resize or "nearest"
        if crop_method == "auto":
            crop_method = "hopper" if self.device.type == "cuda" else "gather"
        elif crop_method == "pallas":
            crop_method = "hopper"
        self.crop_method = crop_method

    # ------------------------------------------------------------------
    def _pipeline(self, depth, com):
        """Fixed-config entry: the constructor's cube, no mirroring."""
        b = depth.shape[0]
        return self._pipeline_cfg(
            depth, com, self.cube.expand(b, 3),
            torch.zeros(b, dtype=torch.bool, device=self.device),
        )

    def _pipeline_cfg(self, depth, com, cube, mirror, invx=False, invy=False):
        """depth (B, H, W) raw mm, com (B, 3) image coords, cube (B, 3) mm
        (the live per-sample cube reaches both the crop and the
        denormalization), mirror (B,) bool: right-hand crops are mirrored
        into the net and the x of the relative pose is flipped back.
        invx/invy flip the relative pose's index 1/0 respectively, the
        reference's swapped-index quirk (realtimehandpose:353-363).

        Returns (joints3d_mm (B, J, 3), com3d (B, 3), crops (B, dh, dw))."""
        cam = self.camera
        kernel = self.crop_method == "hopper" and self.resize != "nd_bilinear"
        clamped = False
        if self.detect or self.refine_iters or not kernel:
            depth, dmin, dmax = clamp_depth(depth)
            clamped = True
            if self.detect:
                com = detect_closest(depth, cube, cam.fx, cam.fy,
                                     min_depth=dmin, max_depth=dmax)
            elif self.refine_iters:
                com = refine_com_iterative(
                    depth, com, cube, cam.fx, cam.fy, self.refine_iters,
                    min_depth=dmin, max_depth=dmax,
                )
        if kernel:
            # without detection the kernel applies the clamp to the pixels
            # it reads: no full-frame clean pass
            crops, _ = hopper_normalized_crop(
                depth, com, cube, cam.fx, cam.fy, self.dsize,
                fuse_clamp=not clamped, use_bilinear=self.resize == "linear",
            )
        else:
            # 'nd_bilinear' on the kernel route takes the plain gather
            method = "onehot" if self.crop_method == "onehot" else "gather"
            crops, _ = normalized_crop(
                depth, com, cube, cam.fx, cam.fy, self.dsize,
                method=method, resize=self.resize,
            )
        net_in = torch.where(mirror[:, None, None], crops.flip(-1), crops)
        out = self.model(net_in[:, None])
        if self.prior is not None:
            out = self.prior.inverse_transform(out)
        pose = out.reshape(out.shape[0], -1, 3)
        # relative-pose sign flips, in the reference's order and indices
        flip = torch.ones((pose.shape[0], 3), dtype=torch.float32, device=pose.device)
        if invx:  # reference invX flips index 1 (realtimehandpose:355-358)
            flip[:, 1] = -1.0
        if invy:  # reference invY flips index 0 (:360-363)
            flip[:, 0] = -1.0
        # un-mirror the x of mirrored (right-hand) poses (:366-369)
        flip[:, 0] = flip[:, 0] * torch.where(mirror, -1.0, 1.0)
        pose = pose * flip[:, None, :]
        com3d = cam.img_to_3d(com)
        joints = pose * (cube[:, 2] / 2.0)[:, None, None] + com3d[:, None, :]
        return joints, com3d, crops

    @torch.inference_mode()
    def __call__(self, depth, com=None, cube=None, mirror=None,
                 invx=False, invy=False):
        """depth (B, H, W) raw mm; com (B, 3) image coords (ignored with
        ``detect``); cube (3,) or (B, 3) mm, default the constructor's;
        mirror bool or (B,) bool.  Inputs may be numpy arrays or tensors;
        they move to the device."""
        dev = self.device
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        b = depth.shape[0]
        if com is None:
            com = torch.zeros((b, 3), dtype=torch.float32, device=dev)
        com = torch.as_tensor(com, dtype=torch.float32, device=dev)
        if cube is None and mirror is None and not invx and not invy:
            return self._pipeline(depth, com)
        cb = self.cube if cube is None else torch.as_tensor(
            cube, dtype=torch.float32, device=dev)
        cb = cb.expand(b, 3)
        if mirror is None:
            mr = torch.zeros(b, dtype=torch.bool, device=dev)
        else:
            mr = torch.as_tensor(mirror, dtype=torch.bool, device=dev).expand(b)
        return self._pipeline_cfg(depth, com, cb, mr, invx=invx, invy=invy)

"""Training-time augmentation on the device.

Counterpart of deepprior_tpu/ops/augment.py (reference
NetTrainer.augmentCrop, src/trainer/nettrainer.py:919-997):

- the mode is drawn uniformly from ``aug_modes`` (a subset of
  {com, rot, sc, none})
- com:  CoM shifted by N(0, sigma_com)^3 mm; the patch re-warped through
        M_new . M^-1 (handdetector.py:678-710); labels shifted
- rot:  in-plane rotation by U(-rot_range, rot_range) deg about the patch
        centre; labels rotated in 2D image space and re-projected
        (handdetector.py:712-747)
- sc:   metric cube scaled by |1 + N(0, sigma_sc)|; the patch re-warped;
        labels unchanged, renormalized by the new cube
        (handdetector.py:750-780)
- the final renormalization maps premax/0/out-of-cube pixels to the cube
  faces as nettrainer.py:985-997 does.

All modes run as one warp with a per-sample transform, then per-sample
labels: no data-dependent control flow.  On a CUDA tensor the warp is a
hand-written kernel (ops/hopper_warp.py, ``warp_route``): K5, which
computes the per-sample geometry from the draws itself and fuses the
un/renormalization, or K4 after ``augment_geometry`` in PyTorch; on the
CPU it is the gather ``warp_patch`` (ops/crop.py) unless the kernels'
plain versions are asked for.

Random draws come from an explicit ``torch.Generator``.  torch and JAX
draw different numbers from one seed, so ``params`` accepts pre-drawn
(mode_idx, off, rot, sc), e.g. from the JAX ``sample_augment_params``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.geometry import (
    inv3x3,
    matmul3x3,
    rotate_points_2d,
    rotation_matrix_2d,
)
from deepprior_tpu_torch.ops import hopper_warp
from deepprior_tpu_torch.ops.crop import com_to_bounds, crop_transform, warp_patch

# the augmentation modes, in the order K5 takes them
VALID_MODES = hopper_warp.MODES
# NYU's invalid-depth marker survives in patches; the reference masks
# values close to it back to background after warping (handdetector.py:793)
NV_VAL = 32000.0


def sample_augment_params(
    generator: Optional[torch.Generator],
    batch: int,
    num_modes: int,
    sigma_com: float = 5.0,
    sigma_sc: float = 0.02,
    rot_range: float = 180.0,
    device=None,
):
    """Draw per-sample augmentation parameters (nettrainer.py:954-957) on
    ``device`` (default: the generator's).

    Returns (mode_idx (B,) int64, off (B, 3), rot (B,), sc (B,)) float32.
    """
    if device is None:
        device = generator.device if generator is not None else "cpu"
    kw = dict(generator=generator, device=device)
    mode = torch.randint(0, num_modes, (batch,), **kw)
    off = torch.randn((batch, 3), **kw) * sigma_com
    rot = torch.empty((batch,), device=device).uniform_(
        -rot_range, rot_range, generator=generator)
    sc = torch.abs(1.0 + torch.randn((batch,), **kw) * sigma_sc)
    return mode, off, rot, sc


def augment_batch(
    generator: Optional[torch.Generator],
    crops_norm,
    gt3d_crop,
    com,
    cube,
    m,
    camera: Camera,
    aug_modes: Sequence[str] = ("com", "rot", "none"),
    sigma_com: float = 5.0,
    sigma_sc: float = 0.02,
    rot_range: float = 180.0,
    norm_zero_one: bool = False,
    use_pallas: Optional[bool] = None,
    fuse_norm: Optional[bool] = None,
    block_k: Optional[int] = None,
    resize: str = "nearest",
    params=None,
):
    """Augment a batch of normalized crops and their labels.

    crops_norm: (B, H, W) normalized crops ([-1, 1] or [0, 1])
    gt3d_crop:  (B, J, 3) CoM-centred 3D labels in mm (not normalized)
    com:        (B, 3) crop CoM in image coords (u, v, d)
    cube:       (B, 3) metric cubes in mm
    m:          (B, 3, 3) crop transforms (full frame -> patch)
    use_pallas: the warp kernels (True) or the gather warp (False); None
                takes the kernels on a CUDA tensor and the gather on the
                CPU.  True on a CPU tensor runs the kernels' plain versions.
    fuse_norm:  on the kernel path, K5 (True or None: the geometry and
                the un/renormalization in the kernel) or K4 (False); on a
                CPU tensor their plain versions, which agree bit for bit
                (chip_smoke.py phase 10 times the two kernels in turns).
    block_k:    the TPU kernel's samples-per-grid-step knob: accepted,
                without effect.
    resize:     'nearest' (the reference default) or 'linear' (the 4-tap
                blend, gather warp only).
    params:     pre-drawn (mode_idx, off, rot, sc) as
                ``sample_augment_params`` returns them; ``generator`` then
                draws nothing.

    Returns (crops_norm', labels_norm' (B, J, 3) scaled by cube'/2, com',
    cube', m').
    """
    for md in aug_modes:
        if md not in VALID_MODES:
            raise ValueError(f"unknown augmentation mode {md!r}")
    if resize not in ("nearest", "linear"):
        raise ValueError(f"unknown resize {resize!r} (nearest|linear)")
    if resize == "linear":
        # every kernel-only knob fails loudly (the warp kernels are
        # nearest-only), as in the JAX package
        if use_pallas:
            raise ValueError("the warp kernel is nearest-only; use_pallas "
                             "must be False/None with resize='linear'")
        if fuse_norm:
            raise ValueError("fuse_norm runs the fused warp kernel, which is "
                             "nearest-only; fuse_norm must be False/None "
                             "with resize='linear'")
        if block_k:
            raise ValueError("block_k blocks the warp kernel, which is "
                             "nearest-only; block_k must be None with "
                             "resize='linear'")
    crops_norm = torch.as_tensor(crops_norm, dtype=torch.float32)
    dev = crops_norm.device
    gt3d_crop = torch.as_tensor(gt3d_crop, dtype=torch.float32, device=dev)
    b, h, w = crops_norm.shape
    if params is None:
        params = sample_augment_params(generator, b, len(aug_modes),
                                       sigma_com, sigma_sc, rot_range,
                                       device=dev)

    # ---- one warp for the whole batch ----
    route = warp_route(dev.type, use_pallas, fuse_norm, resize)
    if route == "k5" and dev.type == "cuda":
        # K5 computes the geometry from the draws and writes the fields the
        # labels need
        args = hopper_warp.warp_norm_args(crops_norm, params, com, cube, m, camera,
                                          aug_modes, norm_zero_one)
        k5 = hopper_warp.launch_warp_norm(crops_norm.contiguous(), args, 0.0, NV_VAL)
        out = k5.out
        geo = AugmentGeometry(
            {name: k5.is_mode[:, i] for i, name in enumerate(VALID_MODES)},
            k5.rot, args.com, k5.com3d, k5.new_com3d_c, k5.new_com, k5.new_cube,
            k5.m_out, None, None)
    else:
        geo = augment_geometry(params, com, cube, m, camera, aug_modes, (h, w),
                               norm_zero_one)
        if route == "k5":  # K5's plain version
            out = hopper_warp.warp_norm_plain(
                crops_norm, hopper_warp.warp_norm_params(geo.a_fwd, geo.norm),
                0.0, NV_VAL)
        else:
            img_mm, premax = hopper_warp.unnormalize(crops_norm, geo.norm)
            if route == "k4":
                # the kernel reads the inverse transforms; the gather warp
                # inverts a_fwd itself
                warped = hopper_warp.warp(img_mm, hopper_warp.warp_patch_params(geo.a_fwd),
                                          0.0, NV_VAL)
            else:
                warped = warp_patch(img_mm, geo.a_fwd, border=0.0, nv_val=NV_VAL,
                                    use_bilinear=(resize == "linear"))
            out = hopper_warp.warp_norm_epilogue(warped, premax, geo.norm)

    # ---- labels ----
    com3d, is_mode = geo.com3d, geo.is_mode
    # com: joints3D + com3D - new_com3D (moveCoM, handdetector.py:708)
    lab_com = gt3d_crop + (com3d - geo.new_com3d_c)[:, None, :]
    # rot: project, rotate about the 2D com, unproject (rotateHand, 740-745)
    joint2d = camera.three_d_to_img(gt3d_crop + com3d[:, None, :])
    rot2d = rotate_points_2d(joint2d, geo.com[:, None, :2], geo.rot[:, None])
    lab_rot = camera.img_to_3d(rot2d) - com3d[:, None, :]
    labels = torch.where(
        is_mode["com"][:, None, None],
        lab_com,
        torch.where(is_mode["rot"][:, None, None], lab_rot, gt3d_crop),
    )
    labels_norm = labels / (geo.new_cube[:, 2] / 2.0)[:, None, None]
    return out, labels_norm, geo.new_com, geo.new_cube, geo.m_out


def warp_route(device_type: str, use_pallas: Optional[bool] = None,
               fuse_norm: Optional[bool] = None, resize: str = "nearest") -> str:
    """The warp ``augment_batch`` runs on a tensor of ``device_type``:
    'k5' (the fused kernel, or its plain version on the CPU; the default of
    the kernel path), 'k4' (the affine warp kernel, or its plain version,
    between the un- and renormalization in PyTorch) or 'gather'
    (``ops.crop.warp_patch``, the only one with resize='linear')."""
    if resize == "linear":
        return "gather"
    if use_pallas is None:
        use_pallas = device_type == "cuda"
    if not use_pallas:
        return "gather"
    return "k4" if fuse_norm is False else "k5"


class AugmentGeometry(NamedTuple):
    """The per-sample geometry of one augmented batch (``augment_geometry``;
    on K5's path the kernel writes it, without a_fwd and norm)."""

    is_mode: Dict[str, torch.Tensor]  # (B,) bool per mode name
    rot: torch.Tensor  # (B,) degrees, mod 360, 0 where not 'rot'
    com: torch.Tensor  # (B, 3) the input CoMs
    com3d: torch.Tensor  # (B, 3) their metric positions
    new_com3d_c: torch.Tensor  # (B, 3) the shifted metric CoMs ('com')
    new_com: torch.Tensor  # (B, 3) the CoMs after augmentation
    new_cube: torch.Tensor  # (B, 3) the cubes after augmentation
    m_out: torch.Tensor  # (B, 3, 3) the crop transforms after augmentation
    a_fwd: Optional[torch.Tensor]  # (B, 3, 3) forward patch -> patch warps
    norm: Optional[torch.Tensor]  # (B, 9) the un/renormalization columns


def augment_geometry(params, com, cube, m, camera: Camera,
                     aug_modes: Sequence[str], hw, norm_zero_one: bool = False
                     ) -> AugmentGeometry:
    """Per-sample transforms of one batch from drawn (mode_idx, off, rot,
    sc): small (B,)-sized tensor math on com's device, before any pixel
    moves.  hw is the patch size (H, W)."""
    com = torch.as_tensor(com, dtype=torch.float32)
    dev = com.device

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    m = f32(m)
    cube = f32(cube).expand(com.shape)
    b = com.shape[0]
    h, w = hw
    img_hw = (camera.height, camera.width)
    mode_idx, off, rot, sc = params
    mode_idx = torch.as_tensor(mode_idx, device=dev)
    off, rot, sc = f32(off), f32(rot), f32(sc)
    is_mode = {name: torch.zeros((b,), dtype=torch.bool, device=dev)
               for name in VALID_MODES}
    for i, name in enumerate(aug_modes):
        is_mode[name] = is_mode[name] | (mode_idx == i)

    # zero the parameters of the modes not drawn, as the reference does
    off = torch.where(is_mode["com"][:, None], off, 0.0)
    # mod once, before both the image matrix and the label rotation use
    # the angle (rotateHand, handdetector.py:729)
    rot = torch.remainder(torch.where(is_mode["rot"], rot, 0.0), 360.0)
    sc = torch.where(is_mode["sc"], sc, 1.0)

    com3d = camera.img_to_3d(com)
    new_com3d_c = com3d + off  # com mode: shifted CoM
    new_com_c = camera.three_d_to_img(new_com3d_c)
    new_cube_s = cube * sc[:, None]  # sc mode: scaled cube
    new_com = torch.where(is_mode["com"][:, None], new_com_c, com)
    new_cube = torch.where(is_mode["sc"][:, None], new_cube_s, cube)

    # new crop transform for com/sc (comToTransform); rot/none keep M
    m_new_geom = crop_transform(new_com, new_cube, camera.fx, camera.fy,
                                img_hw, (w, h))
    needs_recrop = is_mode["com"] | is_mode["sc"]
    m_out = torch.where(needs_recrop[:, None, None], m_new_geom, m)

    # forward patch -> patch transform: com/sc M_new . M^-1 (recropHand,
    # handdetector.py:791), rot R(-rot) about the patch centre (rotateHand,
    # 730-737: the same rotation the labels get), none the identity
    a_recrop = matmul3x3(m_new_geom, inv3x3(m))
    center = torch.tensor([w // 2, h // 2], dtype=torch.float32, device=dev)
    a_rot = rotation_matrix_2d(center.expand(b, 2), rot)
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(b, 3, 3)
    a_fwd = torch.where(
        needs_recrop[:, None, None],
        a_recrop,
        torch.where(is_mode["rot"][:, None, None], a_rot, eye),
    )

    # z-threshold about the new com with the original cube for sc mode
    # (scaleHand passes size=cube, handdetector.py:771-773); rot/none skip
    # the re-threshold
    _, _, _, _, zs_t, ze_t = com_to_bounds(new_com, cube, camera.fx,
                                           camera.fy, img_hw)
    norm = hopper_warp.norm_params(
        com[:, 2], cube[:, 2], needs_recrop, zs_t, ze_t, new_com[:, 2],
        new_cube[:, 2], norm_zero_one)
    return AugmentGeometry(is_mode, rot, com, com3d, new_com3d_c, new_com,
                           new_cube, m_out, a_fwd, norm)

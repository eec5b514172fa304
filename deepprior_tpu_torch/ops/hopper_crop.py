"""The fused clamp + cube crop + normalize as a hand-written CUDA kernel.

Counterpart of deepprior_tpu/ops/pallas_crop.py::pallas_normalized_crop in
its two resize modes: nearest (K1) and the cv2-linear crop of
``use_bilinear=True`` (K2).  The kernel source is csrc/crop.cu;
ops/_build.py compiles it with nvcc on first use and this module calls it
through ctypes.

The per-sample geometry (``com_to_bounds``, ``_embed_geometry``) and the
per-image clamp limits (``depth_limits``) are computed in plain PyTorch
outside the kernel, exactly as the plain version computes them, so that
the kernel and ops/crop.py::normalized_crop can be compared bit for bit.

On a CPU tensor ``hopper_normalized_crop`` runs that plain version.  On a
CUDA tensor it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepprior_tpu_torch.ops.crop import (
    _embed_geometry,
    _transform_matrix,
    clamp_depth,
    com_to_bounds,
    depth_limits,
    normalized_crop,
)

# kernel launches since the last reset, per mode (K1 nearest, K2 linear);
# chip_smoke.py reads them to show that a main path went through the kernel
LAUNCHES = {"normalized_crop": 0, "normalized_crop_linear": 0}

# columns of the params tensor, in the order of csrc/crop.cu's Param enum
PARAM_NAMES = (
    "xstart", "ystart", "wb", "hb", "off_x", "off_y", "zstart", "zend",
    "com_z", "cube_half", "sz_w", "sz_h", "min_d", "max_d",
)
_MAX_GRID_Y = 65535  # the kernel's grid is (ceil(dh*dw/256), B)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile csrc/crop.cu (once per source hash) and load it."""
    from deepprior_tpu_torch.ops._build import load_library

    lib = load_library("crop.cu")
    lib.dp_normalized_crop.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.dp_normalized_crop.restype = ctypes.c_int
    lib.dp_num_params.argtypes = []
    lib.dp_num_params.restype = ctypes.c_int
    lib.dp_error_string.argtypes = [ctypes.c_int]
    lib.dp_error_string.restype = ctypes.c_char_p
    if lib.dp_num_params() != len(PARAM_NAMES):
        raise RuntimeError(
            f"csrc/crop.cu takes {lib.dp_num_params()} params per sample, "
            f"this wrapper builds {len(PARAM_NAMES)}"
        )
    return lib


def crop_params(dpt, com, cube, fx, fy, dsize=(128, 128), fuse_clamp=False):
    """The kernel's (B, 14) float32 per-sample params (``PARAM_NAMES``)
    and the crop transforms M (B, 3, 3) of the same geometry.

    min_d/max_d are the per-image clamp limits with fuse_clamp, else 0
    (the kernel then ignores them)."""
    b, h, w = dpt.shape
    com = torch.as_tensor(com, dtype=torch.float32, device=dpt.device)
    cube = torch.as_tensor(cube, dtype=torch.float32, device=dpt.device)
    cube = cube.expand(com.shape)
    xs, xe, ys, ye, zs, ze = com_to_bounds(com, cube, fx, fy, (h, w))
    scale, off_x, off_y, sz_w, sz_h = _embed_geometry(xs, xe, ys, ye, dsize)
    if fuse_clamp:
        min_d, max_d = depth_limits(dpt)
    else:
        min_d = max_d = torch.zeros_like(xs)
    cols = [
        xs, ys, xe - xs, ye - ys, off_x, off_y, zs, ze,
        com[:, 2], cube[:, 2] / 2.0, sz_w, sz_h, min_d, max_d,
    ]
    m = _transform_matrix(scale, xs, ys, off_x, off_y)
    return torch.stack(cols, dim=1).contiguous(), m


def launch_crop(dpt, params, dsize=(128, 128), fuse_clamp=False,
                norm_zero_one=False, linear=False):
    """Run the kernel on CUDA tensors: raw or clamped depth (B, H, W) and
    ``crop_params`` (B, 14) -> normalized crops (B, dh, dw); the
    cv2-linear crop (K2) when ``linear``, else nearest (K1)."""
    if dpt.device.type != "cuda" or params.device != dpt.device:
        raise ValueError(
            f"launch_crop needs dpt and params on one CUDA device, got "
            f"{dpt.device} and {params.device}"
        )
    if dpt.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(
            f"launch_crop takes float32, got {dpt.dtype} and {params.dtype}"
        )
    if dpt.dim() != 3 or params.shape != (dpt.shape[0], len(PARAM_NAMES)):
        raise ValueError(
            f"bad shapes: dpt {tuple(dpt.shape)} (want (B, H, W)), params "
            f"{tuple(params.shape)} (want (B, {len(PARAM_NAMES)}))"
        )
    if not (dpt.is_contiguous() and params.is_contiguous()):
        raise ValueError("launch_crop needs contiguous dpt and params")
    b, h, w = dpt.shape
    dw, dh = dsize
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    lib = build()
    out = torch.empty((b, dh, dw), dtype=torch.float32, device=dpt.device)
    with torch.cuda.device(dpt.device):
        stream = torch.cuda.current_stream(dpt.device).cuda_stream
        err = lib.dp_normalized_crop(
            dpt.data_ptr(), params.data_ptr(), out.data_ptr(),
            b, h, w, dh, dw, int(fuse_clamp), int(norm_zero_one), int(linear),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"crop kernel launch failed: {lib.dp_error_string(err).decode()}"
        )
    LAUNCHES["normalized_crop_linear" if linear else "normalized_crop"] += 1
    return out


def hopper_normalized_crop(
    dpt,
    com,
    cube,
    fx: float,
    fy: float,
    dsize=(128, 128),
    norm_zero_one: bool = False,
    fuse_clamp: bool = False,
    use_bilinear: bool = False,
    win_rows=None,
    win_cols=None,
    block_k=None,
):
    """Drop-in for ops.crop.normalized_crop (same outputs), with the
    signature of the JAX ``pallas_normalized_crop``.

    dpt: (B, H, W) clamped depth, or raw depth with fuse_clamp=True (the
    kernel applies clamp_depth's per-image limits to the pixels it reads).
    use_bilinear: the cv2-linear crop (K2, ``resize='linear'``), else
    nearest (K1).
    com: (B, 3); cube: (3,) or (B, 3).
    win_rows, win_cols and block_k are the TPU kernel's banded-window and
    blocking knobs; accepted so callers carry over, and without effect.
    Returns (crop_norm (B, dh, dw), M (B, 3, 3)).
    """
    dpt = torch.as_tensor(dpt)
    if dpt.device.type == "cpu":
        if fuse_clamp:
            dpt, _, _ = clamp_depth(dpt)
        return normalized_crop(dpt, com, cube, fx, fy, dsize, norm_zero_one,
                               use_bilinear=use_bilinear)
    if dpt.device.type != "cuda":
        raise ValueError(f"hopper_normalized_crop runs on cpu or cuda, not {dpt.device}")
    params, m = crop_params(dpt, com, cube, fx, fy, dsize, fuse_clamp)
    return launch_crop(dpt, params, dsize, fuse_clamp, norm_zero_one,
                       linear=use_bilinear), m

"""The fused clamp + cube crop + normalize as a hand-written CUDA kernel.

Counterpart of deepprior_tpu/ops/pallas_crop.py::pallas_normalized_crop in
its two resize modes: nearest (K1) and the cv2-linear crop of
``use_bilinear=True`` (K2).  The kernel source is csrc/crop.cu;
ops/_build.py compiles it with nvcc on first use and this module calls it
through ctypes.

The kernel computes each sample's geometry itself (``com_to_bounds``,
``_embed_geometry`` and the crop transform M, op for op as ops/crop.py
computes them) from the CoM, the cube and the focal lengths.  Only the
per-image clamp limits are computed outside it, by ``depth_limits`` (one
``aminmax`` and two clamps), as the JAX package computes them outside its
Pallas kernel.  ``crop_args`` prepares a launch's tensors, so a crop with
the fused clamp is 5 device operations on the card (``aminmax``'s memset
and reduction, two clamps, the kernel) and one without it.

``crop_params`` is the same geometry in plain PyTorch: the CPU path's, the
input of the byte model ``crop_bytes`` and the reference the kernel's
geometry is held to.  On a CPU tensor ``hopper_normalized_crop`` runs the
plain crop (ops/crop.py::normalized_crop).  On a CUDA tensor it launches
the kernel or raises: there is no fallback.  Both go through one
registered operator, ``torch.ops.deepprior_tpu_torch.normalized_crop``
(``normalized_crop_op``), with a fake version for shapes, so that
``torch.export`` can trace the crop and a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from deepprior_tpu_torch.ops.crop import (
    _embed_geometry,
    _exact_floor_div,
    _transform_matrix,
    clamp_depth,
    com_to_bounds,
    depth_limits,
    normalized_crop,
)
from deepprior_tpu_torch.ops.resize import halfpixel_taps
from deepprior_tpu_torch.utils.flops import distinct_per_row

# kernel launches since the last reset, per mode (K1 nearest, K2 linear);
# chip_smoke.py reads them to show that a main path went through the kernel
LAUNCHES = {"normalized_crop": 0, "normalized_crop_linear": 0}
# float32 operations per output pixel, counted from csrc/crop.cu (each add,
# multiply, divide, floor, min, max and compare as one; the index map's
# per-column and per-row work spread over the block's pixels): the
# arithmetic side of the kernels' roofline, far below their bytes
FP32_OPS_PER_PIXEL = {"normalized_crop": 9, "normalized_crop_linear": 35}

# columns of crop_params' (B, 14) geometry
PARAM_NAMES = (
    "xstart", "ystart", "wb", "hb", "off_x", "off_y", "zstart", "zend",
    "com_z", "cube_half", "sz_w", "sz_h", "min_d", "max_d",
)
_MAX_GRID_Y = 65535  # the kernel's grid is (ceil(dh / 32), B)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile csrc/crop.cu (once per source hash) and load it."""
    from deepprior_tpu_torch.ops._build import load_library

    lib = load_library("crop.cu")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # dpt, com, cube, cube_stride, fx, fy, min_d, max_d, out, m,
    # b, h, w, dh, dw, fuse_clamp, norm_zero_one, linear, stream
    lib.dp_normalized_crop.argtypes = (
        [ptr] * 3 + [i32] + [f32] * 2 + [ptr] * 4 + [i32] * 8 + [ptr])
    lib.dp_normalized_crop.restype = i32
    lib.dp_error_string.argtypes = [i32]
    lib.dp_error_string.restype = ctypes.c_char_p
    return lib


def crop_params(dpt, com, cube, fx, fy, dsize=(128, 128), fuse_clamp=False):
    """The per-sample geometry in plain PyTorch, (B, 14) float32 in the
    order of ``PARAM_NAMES``, and the crop transforms M (B, 3, 3): what the
    kernel's prologue computes.

    min_d/max_d are the per-image clamp limits with fuse_clamp, else 0."""
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


def crop_bytes(params, frame_hw, dsize=(128, 128), linear=False) -> int:
    """Bytes K1 (nearest) or K2 (``linear``) must move at least for one
    launch with the geometry ``params`` (``crop_params``'s (B, 14)) over
    (B, *frame_hw) float32 frames: each input byte read once and each
    output byte written once.  The frame pixels are those the embedded
    region's source map reaches inside the frame, counted distinct per
    sample; for K2 the distinct taps its two-tap windows need, not four
    reads per pixel.  The map is separable, so a sample's pixels are its
    distinct columns times its distinct rows.  Plus the (B, dh, dw) output
    and 14 float32 a sample: on the main path (one cube, the clamp fused)
    the kernel reads the CoM (3) and the clamp limits (2) and writes M (9)."""
    h, w = frame_hw
    dw, dh = dsize
    f32 = dict(dtype=torch.float32, device=params.device)

    def col(name):
        return params[:, PARAM_NAMES.index(name), None]

    def distinct(o, off, sz, extent, start, limit):
        inside = (o >= off) & (o < off + sz)
        if linear:
            t0, t1, _ = halfpixel_taps(o, off, sz, extent, start)
            taps, inside = torch.cat([t0, t1], 1), torch.cat([inside, inside], 1)
        else:
            taps = start + _exact_floor_div((o - off) * extent, sz)
        taps = torch.where(inside & (taps >= 0) & (taps < limit), taps, -1.0)
        return distinct_per_row(taps.long())

    nx = distinct(torch.arange(dw, **f32)[None], col("off_x"), col("sz_w"),
                  col("wb"), col("xstart"), w)
    ny = distinct(torch.arange(dh, **f32)[None], col("off_y"), col("sz_h"),
                  col("hb"), col("ystart"), h)
    return 4 * (int((nx * ny).sum()) + params.numel() + params.shape[0] * dh * dw)


class CropArgs(NamedTuple):
    """A launch's tensors besides the frames, from ``crop_args``."""

    com: torch.Tensor            # (B, 3) contiguous float32
    cube: torch.Tensor           # (B, 3), or (3,) read at stride 0
    cube_stride: int             # 3, or 0 for one cube for all samples
    fx: float
    fy: float
    min_d: Optional[torch.Tensor]  # (B,) clamp limits with the fused clamp
    max_d: Optional[torch.Tensor]
    out: torch.Tensor            # (B, dh, dw) normalized crops, written
    m: torch.Tensor              # (B, 3, 3) crop transforms, written


def crop_args(dpt, com, cube, fx, fy, dsize=(128, 128), fuse_clamp=False) -> CropArgs:
    """The kernel's arguments for frames ``dpt`` (B, H, W): the CoM as
    contiguous float32 (B, 3); the cube as (B, 3), or as one (3,) cube
    that the kernel reads at stride 0, which is how a (3,) cube or one
    expanded to (B, 3) arrives, so no copy is made; fx and fy as Python
    floats (the kernel takes them as float32, as PyTorch casts a Python
    float multiplier); with ``fuse_clamp`` the (B,) clamp limits of
    ``depth_limits``; and the outputs (B, dh, dw) and (B, 3, 3), allocated
    here.  Works on any device: the CPU tests check it.  Nothing here reads
    a device value back to the host, so a CUDA call can be captured into a
    CUDA graph."""
    b = dpt.shape[0]
    dev = dpt.device
    com = torch.as_tensor(com, dtype=torch.float32, device=dev).contiguous()
    if com.shape != (b, 3):
        raise ValueError(f"com must be (B, 3) = ({b}, 3), got {tuple(com.shape)}")
    cube = torch.as_tensor(cube, dtype=torch.float32, device=dev)
    if cube.dim() == 2 and (cube.shape[0] == 1 or cube.stride(0) == 0):
        cube = cube[0]  # one cube, expanded over the batch
    if cube.shape == (3,):
        cube, stride = cube.contiguous(), 0
    elif cube.shape == (b, 3):
        cube, stride = cube.contiguous(), 3
    else:
        raise ValueError(f"cube must be (3,) or (B, 3), got {tuple(cube.shape)}")
    min_d, max_d = depth_limits(dpt) if fuse_clamp else (None, None)
    dw, dh = dsize
    out = torch.empty((b, dh, dw), dtype=torch.float32, device=dev)
    m = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    return CropArgs(com, cube, stride, float(fx), float(fy), min_d, max_d, out, m)


def launch_crop(dpt, args: CropArgs, norm_zero_one=False, linear=False):
    """Run the kernel on CUDA tensors: raw or clamped depth (B, H, W) and
    ``crop_args``' tensors -> (normalized crops (B, dh, dw), M (B, 3, 3)),
    written into ``args.out`` and ``args.m``; the cv2-linear crop (K2)
    when ``linear``, else nearest (K1).  The clamp is fused when the args
    carry the clamp limits."""
    name = "normalized_crop_linear" if linear else "normalized_crop"
    tensors = [t for t in (dpt, *args) if isinstance(t, torch.Tensor)]
    if dpt.device.type != "cuda" or any(t.device != dpt.device for t in tensors):
        raise ValueError(
            f"launch_crop needs every tensor on one CUDA device, got "
            f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            f"launch_crop takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("launch_crop needs contiguous tensors")
    if dpt.dim() != 3:
        raise ValueError(f"dpt must be (B, H, W), got {tuple(dpt.shape)}")
    b, h, w = dpt.shape
    dh, dw = args.out.shape[1:]
    fuse_clamp = args.min_d is not None
    want = {"com": (b, 3), "cube": (3,) if args.cube_stride == 0 else (b, 3),
            "out": (b, dh, dw), "m": (b, 3, 3)}
    if fuse_clamp:
        want.update(min_d=(b,), max_d=(b,))
    got = {k: tuple(getattr(args, k).shape) for k in want}
    if got != want or args.out.dim() != 3 or (args.max_d is None) == fuse_clamp:
        raise ValueError(f"crop args of shapes {got}, want {want}")
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    lib = build()
    limits = (args.min_d.data_ptr(), args.max_d.data_ptr()) if fuse_clamp else (None, None)
    with torch.cuda.device(dpt.device):
        stream = torch.cuda.current_stream(dpt.device).cuda_stream
        err = lib.dp_normalized_crop(
            dpt.data_ptr(), args.com.data_ptr(), args.cube.data_ptr(),
            args.cube_stride, args.fx, args.fy, *limits,
            args.out.data_ptr(), args.m.data_ptr(),
            b, h, w, dh, dw, int(fuse_clamp), int(norm_zero_one), int(linear),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"crop kernel launch failed: {lib.dp_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return args.out, args.m


@torch.library.custom_op("deepprior_tpu_torch::normalized_crop", mutates_args=())
def normalized_crop_op(
    dpt: torch.Tensor,
    com: torch.Tensor,
    cube: torch.Tensor,
    fx: float,
    fy: float,
    dw: int,
    dh: int,
    norm_zero_one: bool,
    fuse_clamp: bool,
    linear: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The crop as a registered operator, ``torch.ops.deepprior_tpu_torch.
    normalized_crop``: what ``torch.export`` and a CUDA graph see of K1/K2.
    A ctypes call cannot be traced; an operator with a fake (shape-only)
    version can, and an exported program calls it by name once this module
    is imported.  Functional: returns fresh (crops (B, dh, dw), M (B, 3, 3)).

    On a CUDA tensor: ``crop_args`` and ``launch_crop``, the hand-written
    kernel, which raises on a build or launch failure.  On a CPU tensor:
    the plain crop of ops/crop.py."""
    raise ValueError(f"normalized_crop runs on cpu or cuda, not {dpt.device}")


@normalized_crop_op.register_kernel("cuda")
def _normalized_crop_cuda(dpt, com, cube, fx, fy, dw, dh, norm_zero_one, fuse_clamp,
                          linear):
    args = crop_args(dpt, com, cube, fx, fy, (dw, dh), fuse_clamp)
    return launch_crop(dpt, args, norm_zero_one, linear=linear)


@normalized_crop_op.register_kernel("cpu")
def _normalized_crop_cpu(dpt, com, cube, fx, fy, dw, dh, norm_zero_one, fuse_clamp,
                         linear):
    if fuse_clamp:
        dpt, _, _ = clamp_depth(dpt)
    return normalized_crop(dpt, com, cube, fx, fy, (dw, dh), norm_zero_one,
                           use_bilinear=linear)


@normalized_crop_op.register_fake
def _normalized_crop_fake(dpt, com, cube, fx, fy, dw, dh, norm_zero_one, fuse_clamp,
                          linear):
    b = dpt.shape[0]
    return dpt.new_empty((b, dh, dw)), dpt.new_empty((b, 3, 3))


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
    com: (B, 3); cube: (3,) or (B, 3); fx, fy: Python numbers.
    win_rows, win_cols and block_k are the TPU kernel's banded-window and
    blocking knobs; accepted so callers carry over, and without effect.
    Runs the registered operator ``normalized_crop_op``: the kernel on a
    CUDA tensor, the plain crop on a CPU tensor.
    Returns (crop_norm (B, dh, dw), M (B, 3, 3)).
    """
    dpt = torch.as_tensor(dpt)
    if dpt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hopper_normalized_crop runs on cpu or cuda, not {dpt.device}")
    com = torch.as_tensor(com, dtype=torch.float32, device=dpt.device)
    cube = torch.as_tensor(cube, dtype=torch.float32, device=dpt.device)
    dw, dh = dsize
    return normalized_crop_op(dpt, com, cube, float(fx), float(fy), int(dw), int(dh),
                              bool(norm_zero_one), bool(fuse_clamp), bool(use_bilinear))

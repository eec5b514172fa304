"""The augmentation warps K4 and K5 as hand-written CUDA kernels.

Counterparts of deepprior_tpu/ops/pallas_warp.py: K4 of
``pallas_warp_patch`` (the per-sample affine patch warp) and K5 of
``pallas_warp_norm`` (unnormalize + premax + warp + recrop threshold +
renormalize in one pass).  The kernel source is csrc/warp.cu (with the
shared csrc/geometry.cuh); ops/_build.py compiles it with nvcc on first
use and this module calls it through ctypes.

K4 takes the inverse transforms from ``warp_patch_params``, computed in
plain PyTorch as the JAX wrapper computes them.  K5 takes the
augmentation's draws and the crops' com, cube and M (``warp_norm_args``)
and computes each sample's geometry itself, bit for bit as
ops/augment.py::augment_geometry -> ``warp_patch_params`` ->
``norm_params`` compute it, and writes the per-sample fields the labels
need (``launch_warp_norm``).  Their plain versions are
``warp_patch_plain`` and, for K5, augment_geometry + ``warp_norm_plain``.
Like the Pallas kernel, neither divides by the projective sz;
ops/crop.py::warp_patch, the gather warp, does.

On a CPU tensor the wrappers run the plain version.  On a CUDA tensor
they launch the kernel or raise: there is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.geometry import inv3x3
from deepprior_tpu_torch.ops._build import F32, I32, PTR, bind, launch
from deepprior_tpu_torch.ops.crop import _gather_patch, nv_threshold
from deepprior_tpu_torch.utils.flops import distinct_per_row

# kernel launches since the last reset, per kernel; chip_smoke.py reads
# them to show that the main path went through the kernels
LAUNCHES = {"warp_patch": 0, "warp_norm": 0}
# float32 operations per output pixel, counted from csrc/warp.cu (each add,
# multiply, divide, floor, abs, min, max and compare as one): K4 the map
# (16) and the NV mask (3); K5 the map (14, its row terms once a row), the
# unnormalization (2), the NV mask (3), the recrop threshold (3) and the
# rest of the epilogue (6), and the premax pass (3); its per-sample
# prologue spread over the pixels is below one.  The arithmetic side of
# the kernels' roofline
FP32_OPS_PER_PIXEL = {"warp_patch": 19, "warp_norm": 31}

# columns of the params tensors: K4 takes the inverse transform's top two
# rows; the plain K5 those and then the normalization columns, which K5
# computes itself
PATCH_PARAMS = ("i00", "i01", "i02", "i10", "i11", "i12")
NORM_COLS = ("s_in", "t_in", "thresh", "zs_t", "ze_t", "zstart2", "zend2",
             "t_out", "s_out")
# the augmentation modes, in the order of csrc/warp.cu's Mode enum
MODES = ("none", "com", "rot", "sc")
# K4 and K5 stage one sample's patch in one block's shared memory: the
# card's 227 KB per block, less a margin for K5's constants
MAX_PATCH_BYTES = 227 * 1024 - 1024


build = bind("warp.cu", {
    # patch, params, out, b, h, w, border, use_nv, nv_val, nv_thresh, stream
    "dp_warp_patch": ([PTR] * 3 + [I32] * 3 + [F32, I32, F32, F32] + [PTR], I32),
    # patch, mode_idx, off, rot, sc, com, cube, cube_stride, m, fx, fy, ux,
    # uy, flip_y, img_h, img_w, 4 mode masks, norm_zero_one, border, use_nv,
    # nv_val, nv_thresh, out, new_com, new_cube, m_out, com3d, new_com3d_c,
    # rot_out, is_mode, b, h, w, stream
    "dp_warp_norm": ([PTR] * 7 + [I32, PTR] + [F32] * 4 + [I32] * 3 + [I32] * 4 + [I32]
                     + [F32, I32, F32, F32] + [PTR] * 8 + [I32] * 3 + [PTR], I32),
}, constants=(("params per sample", len(PATCH_PARAMS)), ("modes", len(MODES))))


# ---------------------------------------------------------------------------
# per-sample parameters (plain PyTorch, shared by the kernels and the plain
# versions)
# ---------------------------------------------------------------------------
def warp_patch_params(m_fwd) -> torch.Tensor:
    """(B, 3, 3) forward transforms -> the kernel's (B, 6) params: the top
    two rows of their inverses (``PATCH_PARAMS``)."""
    m_inv = inv3x3(torch.as_tensor(m_fwd, dtype=torch.float32))
    return m_inv[:, :2, :].reshape(-1, len(PATCH_PARAMS)).contiguous()


def norm_params(com_z, cube_z, thresh, zs_t, ze_t, new_com_z, new_cube_z,
                norm_zero_one: bool = False) -> torch.Tensor:
    """The (B, 9) normalization columns (``NORM_COLS``) that K5 and the
    unfused pipeline share, as pallas_warp.py:189-216 computes them:
    com_z/cube_z (B,) unnormalize, thresh (B,) marks the samples that take
    the recrop threshold zs_t/ze_t (B,), new_com_z/new_cube_z (B,)
    renormalize."""
    com_z = torch.as_tensor(com_z, dtype=torch.float32)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=com_z.device)

    cube_z, new_com_z, new_cube_z = f32(cube_z), f32(new_com_z), f32(new_cube_z)
    # unnormalize: img_mm = patch * s_in + t_in (nettrainer.py:948-952)
    if norm_zero_one:
        s_in, t_in = cube_z, com_z - cube_z / 2.0
    else:
        s_in, t_in = cube_z / 2.0, com_z
    # renormalize: out = (clip(d', zstart2, zend2) - t_out) / s_out
    zend2 = new_com_z + new_cube_z / 2.0
    zstart2 = new_com_z - new_cube_z / 2.0
    if norm_zero_one:
        t_out, s_out = zstart2, new_cube_z
    else:
        t_out, s_out = new_com_z, new_cube_z / 2.0
    return torch.stack([s_in, t_in, f32(thresh), f32(zs_t), f32(ze_t), zstart2,
                        zend2, t_out, s_out], dim=1)


def warp_norm_params(m_fwd, norm) -> torch.Tensor:
    """The plain K5's (B, 15) params: ``warp_patch_params(m_fwd)`` followed
    by the normalization columns ``norm`` (B, 9, ``NORM_COLS``)."""
    return torch.cat([warp_patch_params(m_fwd), norm], dim=1).contiguous()


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def _col(params, name):
    """One named column as (B, 1, 1): of K4's (B, 6) params, or of the
    (B, 9) normalization columns, or of K5's (B, 15) params, which end in
    them."""
    if name in PATCH_PARAMS:
        return params[:, PATCH_PARAMS.index(name), None, None]
    return params[:, params.shape[1] - len(NORM_COLS) + NORM_COLS.index(name),
                  None, None]


def _source_pixels(params, h, w):
    """The nearest source pixel (q, p) of each output pixel, (B, h, w)
    floats each: floor(((i00*u) + (i01*v)) + i02 + 0.5), likewise q."""
    u = torch.arange(w, dtype=torch.float32, device=params.device)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=params.device)[None, :, None]
    x = (_col(params, "i00") * u + _col(params, "i01") * v) + _col(params, "i02")
    y = (_col(params, "i10") * u + _col(params, "i11") * v) + _col(params, "i12")
    return torch.floor(y + 0.5), torch.floor(x + 0.5)


def warp_patch_plain(patch, params, border: float = 0.0, nv_val=None):
    """K4's function in plain PyTorch: patch (B, H, W), params (B, 6)."""
    b, h, w = patch.shape
    q, p = _source_pixels(params, h, w)
    val = _gather_patch(patch, q, p, border)
    if nv_val is not None:
        val = torch.where((val - nv_val).abs() <= nv_threshold(nv_val),
                          border, val)
    return val


def warp_bytes(params, hw, fused: bool = False) -> int:
    """Bytes K4 (fused=False) or K5 must move at least for one launch on
    ``params`` ((B, 6) or (B, 15)) over (B, *hw) float32 patches: each
    input byte read once and each output byte written once.  K4 needs only
    the source pixels its nearest map reaches inside the patch, counted
    distinct per sample; K5 reads the whole patch (its premax); both read
    their params and write the (B, H, W) output."""
    b = params.shape[0]
    h, w = hw
    if fused:
        src = b * h * w
    else:
        q, p = _source_pixels(params[:, :len(PATCH_PARAMS)], h, w)
        inside = (p >= 0) & (p < w) & (q >= 0) & (q < h)
        flat = torch.where(inside, q * w + p, -1.0).reshape(b, -1).long()
        src = int(distinct_per_row(flat).sum())
    return 4 * (src + params.numel() + b * h * w)


def unnormalize(patch_norm, norm):
    """Normalized patches (B, H, W) -> mm, img * s_in + t_in
    (nettrainer.py:948-952), and each one's maximum (premax).  norm: the
    (B, 9) normalization columns or K5's (B, 15) params."""
    img = patch_norm * _col(norm, "s_in") + _col(norm, "t_in")
    return img, torch.amax(img, dim=(1, 2))


def warp_norm_epilogue(warped, premax, norm):
    """K5's epilogue on warped mm patches (B, H, W): the recrop z-threshold
    where ``thresh`` > 0 (com/sc samples), premax -> zend, 0 -> zend, clip,
    renormalize (nettrainer.py:985-997).  norm as for ``unnormalize``."""
    thresh = _col(norm, "thresh") > 0.0
    zs_b, ze_b = _col(norm, "zs_t"), _col(norm, "ze_t")
    d = torch.where(thresh & (warped < zs_b) & (warped != 0.0), zs_b, warped)
    d = torch.where(thresh & (d > ze_b), 0.0, d)
    zstart, zend = _col(norm, "zstart2"), _col(norm, "zend2")
    d = torch.where(d == premax[:, None, None], zend, d)
    d = torch.where(d == 0.0, zend, d)
    d = torch.clamp(d, zstart, zend)
    return (d - _col(norm, "t_out")) / _col(norm, "s_out")


def warp_norm_plain(patch_norm, params, border: float = 0.0, nv_val=None):
    """K5's function in plain PyTorch: patch_norm (B, H, W), params
    (B, 15)."""
    img, premax = unnormalize(patch_norm, params)
    warped = warp_patch_plain(img, params[:, :len(PATCH_PARAMS)], border, nv_val)
    return warp_norm_epilogue(warped, premax, params)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------
def _nv_args(nv_val):
    """(use_nv, nv_val, its float32 threshold) as the kernels take them."""
    if nv_val is None:
        return 0, 0.0, 0.0
    return 1, float(nv_val), nv_threshold(nv_val)


def launch_warp(patch, params, border: float = 0.0, nv_val=None):
    """Run K4 on CUDA tensors: patch (B, H, W) float32 and params (B, 6)
    -> (B, H, W)."""
    n_params = len(PATCH_PARAMS)
    if patch.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"warp_patch takes float32, got {patch.dtype} and {params.dtype}")
    if patch.dim() != 3 or params.shape != (patch.shape[0], n_params):
        raise ValueError(
            f"bad shapes: patch {tuple(patch.shape)} (want (B, H, W)), params "
            f"{tuple(params.shape)} (want (B, {n_params}))"
        )
    b, h, w = patch.shape
    if h * w * 4 > MAX_PATCH_BYTES:
        raise ValueError(
            f"a {h}x{w} float32 patch ({h * w * 4} bytes) does not fit in one "
            f"block's shared memory ({MAX_PATCH_BYTES} bytes)"
        )
    out = torch.empty_like(patch)
    launch(build, "dp_warp_patch", "warp_patch", patch, params, out, b, h, w, float(border),
           *_nv_args(nv_val))
    LAUNCHES["warp_patch"] += 1
    return out


def warp(patch, params, border: float = 0.0, nv_val=None):
    """K4 from the inverse transforms ``params`` (B, 6): the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if patch.device.type == "cpu":
        return warp_patch_plain(patch, params, border, nv_val)
    if patch.device.type != "cuda":
        raise ValueError(f"the warp kernels run on cpu or cuda, not {patch.device}")
    return launch_warp(patch.contiguous(), params.contiguous(), border, nv_val)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------
class WarpNormOut(NamedTuple):
    """What one K5 launch writes: the augmented patches and the per-sample
    fields of ops/augment.py::augment_geometry that the labels need."""

    out: torch.Tensor          # (B, H, W) augmented normalized patches
    new_com: torch.Tensor      # (B, 3)
    new_cube: torch.Tensor     # (B, 3)
    m_out: torch.Tensor        # (B, 3, 3)
    com3d: torch.Tensor        # (B, 3)
    new_com3d_c: torch.Tensor  # (B, 3)
    rot: torch.Tensor          # (B,) degrees, mod 360, 0 where not 'rot'
    is_mode: torch.Tensor      # (B, 4) bool, one column per mode of MODES


class WarpNormArgs(NamedTuple):
    """A K5 launch's tensors besides the patches, from ``warp_norm_args``."""

    mode_idx: torch.Tensor  # (B,) int64: the slot of aug_modes drawn
    off: torch.Tensor       # (B, 3) com shifts in mm
    rot: torch.Tensor       # (B,) angles in degrees
    sc: torch.Tensor        # (B,) cube scales
    com: torch.Tensor       # (B, 3) the crops' CoMs
    cube: torch.Tensor      # (B, 3), or (3,) read at stride 0
    cube_stride: int        # 3, or 0 for one cube for all samples
    m: torch.Tensor         # (B, 3, 3) the crops' transforms
    camera: Camera
    masks: tuple            # per mode of MODES, bit i set if aug_modes[i] is it
    norm_zero_one: bool
    outs: WarpNormOut       # allocated here, written by the launch


def warp_norm_args(patch, params, com, cube, m, camera: Camera,
                   aug_modes: Sequence[str], norm_zero_one: bool = False
                   ) -> WarpNormArgs:
    """K5's arguments for patches ``patch`` (B, H, W): the draws ``params``
    (mode_idx, off, rot, sc) as ``sample_augment_params`` returns them,
    mode_idx as int64 and the rest, com, cube and m as contiguous float32
    on the patches' device (already so: no copy); the cube as (B, 3) or as
    one (3,) cube read at stride 0, as ``hopper_crop.crop_args`` takes it;
    the mode masks of ``aug_modes``; and the outputs, allocated here.
    Works on any device: the CPU tests check it.  Nothing here reads a
    device value back to the host."""
    b = patch.shape[0]
    dev = patch.device

    def f32(a, shape, name):
        t = torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        return t

    mode_idx, off, rot, sc = params
    mode_idx = torch.as_tensor(mode_idx, device=dev).to(torch.int64).contiguous()
    if mode_idx.shape != (b,):
        raise ValueError(f"mode_idx must be ({b},), got {tuple(mode_idx.shape)}")
    off, rot, sc = f32(off, (b, 3), "off"), f32(rot, (b,), "rot"), f32(sc, (b,), "sc")
    com, m = f32(com, (b, 3), "com"), f32(m, (b, 3, 3), "m")
    cube = torch.as_tensor(cube, dtype=torch.float32, device=dev)
    if cube.dim() == 2 and (cube.shape[0] == 1 or cube.stride(0) == 0):
        cube = cube[0]  # one cube, expanded over the batch
    if cube.shape == (3,):
        cube, stride = cube.contiguous(), 0
    elif cube.shape == (b, 3):
        cube, stride = cube.contiguous(), 3
    else:
        raise ValueError(f"cube must be (3,) or (B, 3), got {tuple(cube.shape)}")
    for md in aug_modes:
        if md not in MODES:
            raise ValueError(f"unknown augmentation mode {md!r}")
    if len(aug_modes) > 31:
        raise ValueError(f"K5 takes at most 31 aug_modes slots, got {len(aug_modes)}")
    masks = tuple(sum(1 << i for i, md in enumerate(aug_modes) if md == name)
                  for name in MODES)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = WarpNormOut(empty(*patch.shape), empty(b, 3), empty(b, 3), empty(b, 3, 3),
                       empty(b, 3), empty(b, 3), empty(b),
                       empty(b, len(MODES), dtype=torch.bool))
    return WarpNormArgs(mode_idx, off, rot, sc, com, cube, stride, m, camera, masks,
                        bool(norm_zero_one), outs)


def launch_warp_norm(patch, args: WarpNormArgs, border: float = 0.0,
                     nv_val=None) -> WarpNormOut:
    """Run K5 on CUDA tensors: normalized patches (B, H, W) float32 and
    ``warp_norm_args``' tensors -> ``args.outs``, written by one launch of
    one block per sample, which stages the whole patch in its shared memory
    (``MAX_PATCH_BYTES``).  A refused launch raises."""
    tensors = [t for t in (patch, *args[:8], *args.outs) if isinstance(t, torch.Tensor)]
    dtypes = {id(args.mode_idx): torch.int64, id(args.outs.is_mode): torch.bool}
    if any(t.dtype != dtypes.get(id(t), torch.float32) for t in tensors):
        raise TypeError(f"warp_norm takes float32 (mode_idx int64, is_mode bool), got "
                        f"{[t.dtype for t in tensors]}")
    if patch.dim() != 3 or args.outs.out.shape != patch.shape:
        raise ValueError(f"patch must be (B, H, W) like args.outs.out, got "
                         f"{tuple(patch.shape)} and {tuple(args.outs.out.shape)}")
    b, h, w = patch.shape
    if args.mode_idx.shape != (b,):
        raise ValueError(f"args are for {args.mode_idx.shape[0]} samples, patch has {b}")
    if h * w * 4 > MAX_PATCH_BYTES:
        raise ValueError(
            f"a {h}x{w} float32 patch ({h * w * 4} bytes) does not fit in one "
            f"block's shared memory ({MAX_PATCH_BYTES} bytes)")
    cam, o = args.camera, args.outs
    launch(build, "dp_warp_norm", "warp_norm", patch, args.mode_idx, args.off, args.rot,
           args.sc, args.com, args.cube, args.cube_stride, args.m, float(cam.fx),
           float(cam.fy), float(cam.ux), float(cam.uy), int(cam.flip_y), int(cam.height),
           int(cam.width), *args.masks, int(args.norm_zero_one), float(border),
           *_nv_args(nv_val), *o, b, h, w)
    LAUNCHES["warp_norm"] += 1
    return o


# The JAX package's signatures, for the parity tests and chip_smoke.py, which
# hold the port against pallas_warp_patch / pallas_warp_norm call for call.
# The training path calls ``warp`` and ``launch_warp_norm``.
def hopper_warp_patch(patch, m_fwd, border: float = 0.0, nv_val=None,
                      block_k=None):
    """K4 with the signature of the JAX ``pallas_warp_patch``: patch
    (B, H, W) float32 mm, m_fwd (B, 3, 3) forward transforms -> (B, H, W).
    A test seam: the training path calls ``warp``.

    block_k is the TPU kernel's samples-per-grid-step knob; accepted so
    callers carry over, and without effect."""
    patch = torch.as_tensor(patch, dtype=torch.float32)
    params = warp_patch_params(torch.as_tensor(m_fwd, device=patch.device))
    return warp(patch, params, border, nv_val)


def hopper_warp_norm(patch_norm, m_fwd, com_z, cube_z, thresh, zs_t, ze_t,
                     new_com_z, new_cube_z, norm_zero_one: bool = False,
                     border: float = 0.0, nv_val=None):
    """K5's function with the signature of the JAX ``pallas_warp_norm``:
    normalized patches (B, H, W) -> augmented normalized patches; the
    per-sample scalars (B,) as ``norm_params`` takes them.  A test seam for
    CPU tensors, where it runs ``warp_norm_plain``: K5 computes these
    scalars itself from the augmentation draws, so on the card the path is
    ``warp_norm_args`` + ``launch_warp_norm`` (ops/augment.py)."""
    patch_norm = torch.as_tensor(patch_norm, dtype=torch.float32)
    if patch_norm.device.type != "cpu":
        raise ValueError(
            "hopper_warp_norm runs the plain K5 on cpu tensors; K5 on the card "
            "takes the augmentation draws: warp_norm_args + launch_warp_norm")
    norm = norm_params(com_z, cube_z, thresh, zs_t, ze_t, new_com_z, new_cube_z,
                       norm_zero_one)
    params = warp_norm_params(torch.as_tensor(m_fwd), norm)
    return warp_norm_plain(patch_norm, params, border, nv_val)

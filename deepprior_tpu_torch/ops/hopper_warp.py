"""The augmentation warps K4 and K5 as hand-written CUDA kernels.

Counterparts of deepprior_tpu/ops/pallas_warp.py: ``hopper_warp_patch``
of ``pallas_warp_patch`` (K4, the per-sample affine patch warp) and
``hopper_warp_norm`` of ``pallas_warp_norm`` (K5, unnormalize + premax +
warp + recrop threshold + renormalize in one pass).  The kernel source is
csrc/warp.cu; ops/_build.py compiles it with nvcc on first use and this
module calls it through ctypes.

ops/augment.py calls ``warp`` with params it builds from
``warp_patch_params`` and ``norm_params``; the two JAX-signature wrappers
serve the parity tests.

The per-sample parameters (the inverse transforms from ``inv3x3`` and,
for K5, the normalization scalars) are computed in plain PyTorch outside
the kernel, as the JAX wrappers compute them, so that the kernel and its
plain version (``warp_patch_plain``, ``warp_norm_plain``) read the same
bits and agree bit for bit.  Like the Pallas kernel, neither divides by
the projective sz; ops/crop.py::warp_patch, the gather warp, does.

On a CPU tensor the wrappers run the plain version.  On a CUDA tensor
they launch the kernel or raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepprior_tpu_torch.geometry import inv3x3
from deepprior_tpu_torch.ops.crop import _gather_patch, nv_threshold

# kernel launches since the last reset, per kernel; chip_smoke.py reads
# them to show that the main path went through the kernels
LAUNCHES = {"warp_patch": 0, "warp_norm": 0}

# columns of the params tensors, in the order of csrc/warp.cu's Param enum:
# K4 takes the inverse transform's top two rows, K5 those and then the
# normalization columns
PATCH_PARAMS = ("i00", "i01", "i02", "i10", "i11", "i12")
NORM_COLS = ("s_in", "t_in", "thresh", "zs_t", "ze_t", "zstart2", "zend2",
             "t_out", "s_out")
NORM_PARAMS = PATCH_PARAMS + NORM_COLS
# a block stages one sample's patch in shared memory (csrc/warp.cu): the
# card's 227 KB per block, less room for the kernel's static reduction slots
MAX_PATCH_BYTES = 227 * 1024 - 1024


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile csrc/warp.cu (once per source hash) and load it."""
    from deepprior_tpu_torch.ops._build import load_library

    lib = load_library("warp.cu")
    for fn in (lib.dp_warp_patch, lib.dp_warp_norm):
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.dp_warp_num_params.argtypes = [ctypes.c_int]
    lib.dp_warp_num_params.restype = ctypes.c_int
    lib.dp_warp_error_string.argtypes = [ctypes.c_int]
    lib.dp_warp_error_string.restype = ctypes.c_char_p
    for fused, names in ((0, PATCH_PARAMS), (1, NORM_PARAMS)):
        if lib.dp_warp_num_params(fused) != len(names):
            raise RuntimeError(
                f"csrc/warp.cu takes {lib.dp_warp_num_params(fused)} params "
                f"per sample (fused={fused}), this wrapper builds {len(names)}"
            )
    return lib


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
    """K5's (B, 15) params (``NORM_PARAMS``): ``warp_patch_params(m_fwd)``
    followed by the normalization columns ``norm`` (B, 9)."""
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


def warp_patch_plain(patch, params, border: float = 0.0, nv_val=None):
    """K4's function in plain PyTorch: patch (B, H, W), params (B, 6)."""
    b, h, w = patch.shape
    u = torch.arange(w, dtype=torch.float32, device=patch.device)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=patch.device)[None, :, None]
    x = (_col(params, "i00") * u + _col(params, "i01") * v) + _col(params, "i02")
    y = (_col(params, "i10") * u + _col(params, "i11") * v) + _col(params, "i12")
    val = _gather_patch(patch, torch.floor(y + 0.5), torch.floor(x + 0.5), border)
    if nv_val is not None:
        val = torch.where((val - nv_val).abs() <= nv_threshold(nv_val),
                          border, val)
    return val


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
# the kernels
# ---------------------------------------------------------------------------
def launch_warp(patch, params, border: float = 0.0, nv_val=None,
                fused: bool = False):
    """Run K4 (fused=False) or K5 on CUDA tensors: patch (B, H, W) float32
    and params (B, 6) or (B, 15) -> (B, H, W)."""
    name = "warp_norm" if fused else "warp_patch"
    n_params = len(NORM_PARAMS if fused else PATCH_PARAMS)
    if patch.device.type != "cuda" or params.device != patch.device:
        raise ValueError(
            f"{name} needs patch and params on one CUDA device, got "
            f"{patch.device} and {params.device}"
        )
    if patch.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {patch.dtype} and {params.dtype}")
    if patch.dim() != 3 or params.shape != (patch.shape[0], n_params):
        raise ValueError(
            f"bad shapes: patch {tuple(patch.shape)} (want (B, H, W)), params "
            f"{tuple(params.shape)} (want (B, {n_params}))"
        )
    if not (patch.is_contiguous() and params.is_contiguous()):
        raise ValueError(f"{name} needs contiguous patch and params")
    b, h, w = patch.shape
    if h * w * 4 > MAX_PATCH_BYTES:
        raise ValueError(
            f"a {h}x{w} float32 patch ({h * w * 4} bytes) does not fit in one "
            f"block's shared memory ({MAX_PATCH_BYTES} bytes)"
        )
    lib = build()
    out = torch.empty_like(patch)
    fn = lib.dp_warp_norm if fused else lib.dp_warp_patch
    use_nv = nv_val is not None
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream(patch.device).cuda_stream
        err = fn(
            patch.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w,
            float(border), int(use_nv), float(nv_val) if use_nv else 0.0,
            nv_threshold(nv_val) if use_nv else 0.0, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.dp_warp_error_string(err).decode()}"
        )
    LAUNCHES[name] += 1
    return out


def warp(patch, params, border: float = 0.0, nv_val=None, fused: bool = False):
    """K4 (fused=False) or K5 from precomputed params: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if patch.device.type == "cpu":
        plain = warp_norm_plain if fused else warp_patch_plain
        return plain(patch, params, border, nv_val)
    if patch.device.type != "cuda":
        raise ValueError(f"the warp kernels run on cpu or cuda, not {patch.device}")
    return launch_warp(patch.contiguous(), params.contiguous(), border, nv_val,
                       fused)


# The JAX package's signatures, for the parity tests and chip_smoke.py, which
# hold the port against pallas_warp_patch / pallas_warp_norm call for call.
# The training path calls ``warp`` with the params ops/augment.py builds.
def hopper_warp_patch(patch, m_fwd, border: float = 0.0, nv_val=None,
                      block_k=None):
    """K4 with the signature of the JAX ``pallas_warp_patch``: patch
    (B, H, W) float32 mm, m_fwd (B, 3, 3) forward transforms -> (B, H, W).
    A test seam: the training path calls ``warp``.

    block_k is the TPU kernel's samples-per-grid-step knob; accepted so
    callers carry over, and without effect."""
    patch = torch.as_tensor(patch, dtype=torch.float32)
    params = warp_patch_params(torch.as_tensor(m_fwd, device=patch.device))
    return warp(patch, params, border, nv_val, fused=False)


def hopper_warp_norm(patch_norm, m_fwd, com_z, cube_z, thresh, zs_t, ze_t,
                     new_com_z, new_cube_z, norm_zero_one: bool = False,
                     border: float = 0.0, nv_val=None):
    """K5 with the signature of the JAX ``pallas_warp_norm``: normalized
    patches (B, H, W) -> augmented normalized patches; the per-sample
    scalars (B,) as ``norm_params`` takes them.  A test seam: the training
    path calls ``warp``."""
    patch_norm = torch.as_tensor(patch_norm, dtype=torch.float32)
    norm = norm_params(torch.as_tensor(com_z, device=patch_norm.device), cube_z,
                       thresh, zs_t, ze_t, new_com_z, new_cube_z, norm_zero_one)
    params = warp_norm_params(torch.as_tensor(m_fwd, device=patch_norm.device), norm)
    return warp(patch_norm, params, border, nv_val, fused=True)

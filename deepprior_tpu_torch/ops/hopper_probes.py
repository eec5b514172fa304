"""The measurement probes K6 and K7 as hand-written CUDA kernels.

Counterparts of the TPU probes in prof_bench.py (K6: the band read with a
trivial body, ``run_trivial``; with the HIGHEST one-hot selection,
``run_mm``; with the DEFAULT one, ``run_mm_def``) and prof_warp_bf16.py
(K7: the general nearest warp, ``make('f32')`` and ``make('split')``).
The kernel source is csrc/probes.cu; ops/_build.py compiles it with nvcc
on first use and this module calls it through ctypes.
deepprior_tpu_torch/prof/ holds the scripts that time them.

Each kernel has its plain PyTorch version here: ``band_plain`` and
``warp_general_plain``.  On a CPU tensor the wrappers run it; on a CUDA
tensor they launch the kernel or raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from deepprior_tpu_torch.ops.hopper_warp import warp_patch_params, warp_patch_plain

# kernel launches since the last reset, per kernel; chip_smoke.py reads them
# to show that the probe scripts went through the kernels
LAUNCHES = {"band_trivial": 0, "band_select": 0, "band_select_bf16": 0,
            "warp_general": 0, "warp_general_split": 0}
# float32 operations per output pixel, counted from csrc/probes.cu (each
# add, multiply, floor, compare and bf16 conversion as one; K7's row terms
# i01 * v and i11 * v once for its 4 pixels)
FP32_OPS_PER_PIXEL = {"band_trivial": 0, "band_select": 0, "band_select_bf16": 2,
                      "warp_general": 15, "warp_general_split": 25}

# the band bodies, in the order of csrc/probes.cu's Body enum
BODIES = ("trivial", "select", "select_bf16")
CORNER = 128            # each sample's (CORNER, CORNER) output
SEL_ROW, SEL_COL = 64, 32   # the selection bodies output band[SEL_ROW, SEL_COL]
# the TPU's BlockSpec takes band offsets in rows of 8 and columns of 128
ROW_ALIGN, COL_ALIGN = 8, 128
_MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile csrc/probes.cu (once per source hash) and load it."""
    from deepprior_tpu_torch.ops._build import load_library

    lib = load_library("probes.cu")
    lib.dp_band_probe.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dp_band_probe.restype = ctypes.c_int
    lib.dp_warp_general.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.dp_warp_general.restype = ctypes.c_int
    lib.dp_probe_constant.argtypes = [ctypes.c_int]
    lib.dp_probe_constant.restype = ctypes.c_int
    lib.dp_probe_error_string.argtypes = [ctypes.c_int]
    lib.dp_probe_error_string.restype = ctypes.c_char_p
    got = tuple(lib.dp_probe_constant(i) for i in range(3))
    if got != (CORNER, SEL_ROW, SEL_COL):
        raise RuntimeError(
            f"csrc/probes.cu has (corner, sel_row, sel_col) {got}, "
            f"this wrapper {(CORNER, SEL_ROW, SEL_COL)}")
    return lib


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {build().dp_probe_error_string(err).decode()}")


# ---------------------------------------------------------------------------
# K6: the band read
# ---------------------------------------------------------------------------
def check_offsets(offsets, frame_hw, band) -> np.ndarray:
    """The band offsets (B, 2) (first row, first column) as int32, after
    the checks the TPU's BlockSpec imposes and that keep the band in the
    frame: integer-valued, rows a multiple of 8, columns a multiple of 128,
    0 <= row <= H - band_h and 0 <= column <= W - band_w.  Raises
    ValueError otherwise."""
    offs = torch.as_tensor(offsets).detach().cpu().numpy()
    if offs.ndim != 2 or offs.shape[1] != 2:
        raise ValueError(f"offsets must be (B, 2), got {offs.shape}")
    if not np.array_equal(offs, np.round(offs)):
        raise ValueError("band offsets must be whole pixels")
    offs = offs.astype(np.int64)
    (h, w), (bh, bw) = frame_hw, band
    rows, cols = offs[:, 0], offs[:, 1]
    if (rows % ROW_ALIGN).any() or (cols % COL_ALIGN).any():
        raise ValueError(
            f"band offsets must be rows in multiples of {ROW_ALIGN} and columns "
            f"in multiples of {COL_ALIGN}, got {offs.tolist()}")
    if (rows < 0).any() or (cols < 0).any() or (rows + bh > h).any() or (cols + bw > w).any():
        raise ValueError(
            f"a {bh}x{bw} band at {offs.tolist()} leaves the {h}x{w} frame")
    return offs.astype(np.int32)


def band_plain(dpt, offsets, body: str = "trivial"):
    """K6's function in plain PyTorch: dpt (B, H, W), offsets (B, 2)
    integer -> (B, CORNER, CORNER).  'trivial': the band's corner;
    'select': band[SEL_ROW, SEL_COL] in every pixel, what the HIGHEST
    one-hot matmuls compute; 'select_bf16': that value rounded to bf16,
    what one DEFAULT bf16 pass on a TPU computes."""
    if body not in BODIES:
        raise ValueError(f"unknown band body {body!r} (want one of {BODIES})")
    b = dpt.shape[0]
    offsets = torch.as_tensor(offsets, device=dpt.device).long()
    r, c = offsets[:, 0], offsets[:, 1]
    idx = torch.arange(b, device=dpt.device)
    if body == "trivial":
        k = torch.arange(CORNER, device=dpt.device)
        return dpt[idx[:, None, None], (r[:, None] + k)[:, :, None],
                   (c[:, None] + k)[:, None, :]]
    x = dpt[idx, r + SEL_ROW, c + SEL_COL]
    if body == "select_bf16":
        x = x.to(torch.bfloat16).float()
    return x[:, None, None].expand(b, CORNER, CORNER)


def launch_band(dpt, offsets, band, body: str = "trivial"):
    """Run K6a/b/c on CUDA tensors: dpt (B, H, W) float32 and offsets
    (B, 2) int32 (checked by ``check_offsets``) -> (B, CORNER, CORNER)."""
    if body not in BODIES:
        raise ValueError(f"unknown band body {body!r} (want one of {BODIES})")
    if dpt.device.type != "cuda" or offsets.device != dpt.device:
        raise ValueError(f"band probe needs dpt and offsets on one CUDA device, "
                         f"got {dpt.device} and {offsets.device}")
    if dpt.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise TypeError(f"band probe takes float32 dpt and int32 offsets, got "
                        f"{dpt.dtype} and {offsets.dtype}")
    b, h, w = dpt.shape
    bh, bw = band
    if offsets.shape != (b, 2) or not (dpt.is_contiguous() and offsets.is_contiguous()):
        raise ValueError(f"band probe needs contiguous dpt (B, H, W) and offsets "
                         f"(B, 2), got {tuple(dpt.shape)} and {tuple(offsets.shape)}")
    if w % 4 or dpt.data_ptr() % 16:
        raise ValueError("band probe reads 16-byte vectors: W must be a multiple "
                         "of 4 and dpt 16-byte aligned")
    if bh < CORNER or bw < CORNER or bh > h or bw > w:
        raise ValueError(f"band {bh}x{bw}: needs at least {CORNER}x{CORNER} and "
                         f"to fit the {h}x{w} frame")
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    lib = build()
    out = torch.empty((b, CORNER, CORNER), dtype=torch.float32, device=dpt.device)
    with torch.cuda.device(dpt.device):
        stream = torch.cuda.current_stream(dpt.device).cuda_stream
        err = lib.dp_band_probe(dpt.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                                b, h, w, bh, bw, BODIES.index(body), stream)
    _raise_on(err, f"band_{body}")
    LAUNCHES[f"band_{body}"] += 1
    return out


def band_probe(dpt, offsets, band=(304, 512), body: str = "trivial"):
    """K6 with the TPU probes' arguments: frames (B, H, W) float32, the
    band offsets (B, 2) (``check_offsets``), the band's (rows, cols) and
    the body ('trivial' = run_trivial, 'select' = run_mm, 'select_bf16' =
    run_mm_def) -> (B, CORNER, CORNER).  The kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    offs = torch.from_numpy(check_offsets(offsets, tuple(dpt.shape[1:]), band))
    if dpt.device.type == "cpu":
        return band_plain(dpt, offs, body)
    if dpt.device.type != "cuda":
        raise ValueError(f"the band probe runs on cpu or cuda, not {dpt.device}")
    return launch_band(dpt.contiguous(), offs.to(dpt.device), band, body)


def band_read_bytes(shape, band) -> int:
    """Bytes the TPU probes move by design for frames of ``shape`` (B, H,
    W): each sample's whole band DMA'd once, its offsets, and the (CORNER,
    CORNER) float32 output written once.  The CUDA kernels read only what
    the output needs (``band_need_bytes``)."""
    b = shape[0]
    return b * (band[0] * band[1] * 4 + 2 * 4 + CORNER * CORNER * 4)


def band_need_bytes(shape, body: str = "trivial") -> int:
    """Bytes K6's function needs for frames of ``shape`` (B, H, W): the
    offsets, the corner read once ('trivial') or the one selected pixel
    (the selection bodies), and the output written once."""
    b = shape[0]
    read = CORNER * CORNER * 4 if body == "trivial" else 4
    return b * (read + 2 * 4 + CORNER * CORNER * 4)


# ---------------------------------------------------------------------------
# K7: the general nearest warp, 'f32' and 'split'
# ---------------------------------------------------------------------------
def split3_bf16(x):
    """x rebuilt from its three bf16 parts, summed in the order of the TPU
    probe's three dots: (a1 + a2) + a3 with a1 = bf16(x), a2 = bf16(x - a1),
    a3 = bf16(x - a1 - a2)."""
    a1 = x.to(torch.bfloat16).float()
    r1 = x - a1
    a2 = r1.to(torch.bfloat16).float()
    a3 = (r1 - a2).to(torch.bfloat16).float()
    return (a1 + a2) + a3


def warp_general_plain(patch, params, split: bool = False):
    """K7's function in plain PyTorch: patch (B, H, W), params (B, 6) (the
    inverse transforms' top two rows, ``warp_patch_params``) -> the nearest
    warp with 0 outside, no NV mask: K4's plain version with border 0;
    ``split`` rebuilds each value from its bf16 parts."""
    val = warp_patch_plain(patch, params, 0.0, None)
    return split3_bf16(val) if split else val


def launch_warp_general(patch, params, split: bool = False):
    """Run K7 on CUDA tensors: patch (B, H, W) float32, params (B, 6)
    float32 -> (B, H, W)."""
    name = "warp_general_split" if split else "warp_general"
    if patch.device.type != "cuda" or params.device != patch.device:
        raise ValueError(f"{name} needs patch and params on one CUDA device, got "
                         f"{patch.device} and {params.device}")
    if patch.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {patch.dtype} and {params.dtype}")
    if patch.dim() != 3 or params.shape != (patch.shape[0], 6):
        raise ValueError(f"bad shapes: patch {tuple(patch.shape)} (want (B, H, W)), "
                         f"params {tuple(params.shape)} (want (B, 6))")
    if not (patch.is_contiguous() and params.is_contiguous()):
        raise ValueError(f"{name} needs contiguous patch and params")
    b, h, w = patch.shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    lib = build()
    out = torch.empty_like(patch)
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream(patch.device).cuda_stream
        err = lib.dp_warp_general(patch.data_ptr(), params.data_ptr(), out.data_ptr(),
                                  b, h, w, int(split), stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def warp_general(patch, m_fwd, split: bool = False):
    """K7 with the TPU probe's arguments: patch (B, H, W) float32, m_fwd
    (B, 3, 3) forward transforms, inverted by ``inv3x3`` outside the
    kernel as prof_warp_bf16.py:51-53 does -> (B, H, W).  The kernel on a
    CUDA tensor, the plain version on a CPU tensor.  K7's bytes are K4's
    (``hopper_warp.warp_bytes``): the same map reads the same pixels."""
    patch = torch.as_tensor(patch, dtype=torch.float32)
    params = warp_patch_params(torch.as_tensor(m_fwd, device=patch.device))
    if patch.device.type == "cpu":
        return warp_general_plain(patch, params, split)
    if patch.device.type != "cuda":
        raise ValueError(f"the general warp runs on cpu or cuda, not {patch.device}")
    return launch_warp_general(patch.contiguous(), params, split)

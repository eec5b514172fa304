"""Flop accounting, hardware peaks and MFU (counterpart of
deepprior_tpu/utils/flops.py).

MFU = executed flops / (wall time x peak matmul flops).  Model flops come
from ``torch.utils.flop_counter.FlopCounterMode`` (``model_flops``), which
counts every convolution and matrix product a call dispatches, 2 x MAC
each.  The port's crops and warps are gathers and add no flops; the TPU
kernel's selection matmuls are what ``crop_selection_flops`` counts, and
it is kept as the JAX package has it.

Peaks are per card, matched on ``torch.cuda.get_device_name()``: the dense
bf16 tensor-core rate (the MFU denominator), the float32 rate outside the
tensor cores (what a kernel's elementwise arithmetic runs at) and the
device memory rate (the roofline's other side).  DEEPPRIOR_PEAK_TFLOPS
overrides the bf16 peak for hardware not listed.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch


class Peak(NamedTuple):
    bf16_tflops: float  # dense, tensor cores
    fp32_tflops: float  # outside the tensor cores
    hbm_tbps: float
    source: str


_H100_SXM = Peak(989.0, 67.0, 3.35, "NVIDIA H100 Tensor Core GPU data sheet, SXM column")
# matched in order on the lower-cased device name; "H100 80GB HBM3" is the
# name torch.cuda.get_device_name gives the SXM part
_PEAKS = (
    ("h100 80gb hbm3", _H100_SXM),
    ("h100 sxm", _H100_SXM),
)


def _peak(device=None) -> Optional[Peak]:
    """The ``_PEAKS`` row of ``device`` (default: the current CUDA device);
    None on the CPU and for a card not listed."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAKS:
        if key in name:
            return peak
    return None


def peak_tflops(device=None) -> Optional[float]:
    """Per-card dense bf16 peak, TFLOP/s, for ``device`` (default: the
    current CUDA device).

    Returns None on the CPU and for hardware not listed, unless
    DEEPPRIOR_PEAK_TFLOPS is set; callers should then omit MFU rather than
    report a made-up number."""
    env = os.environ.get("DEEPPRIOR_PEAK_TFLOPS")
    if env:
        return float(env)
    peak = _peak(device)
    return None if peak is None else peak.bf16_tflops


def peak_fp32_tflops(device=None) -> Optional[float]:
    """Per-card float32 peak outside the tensor cores, TFLOP/s; None on the
    CPU and for hardware not listed."""
    peak = _peak(device)
    return None if peak is None else peak.fp32_tflops


def peak_hbm_tbps(device=None) -> Optional[float]:
    """Per-card device-memory bandwidth, TB/s; None on the CPU and for
    hardware not listed."""
    peak = _peak(device)
    return None if peak is None else peak.hbm_tbps


def model_flops(fn, *args, **kwargs) -> Optional[float]:
    """Flops of one call ``fn(*args, **kwargs)`` as FlopCounterMode counts
    them (convolutions and matrix products, 2 x MAC); None when the call
    dispatches none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def crop_selection_flops(
    batch: int,
    win_h: int,
    win_w: int,
    dh: int = 128,
    dw: int = 128,
    bilinear: bool = False,
) -> float:
    """Executed flops of the Pallas crop's selection matmuls (per batch).

    Mirrors ops/pallas_crop.py::_crop_kernel.select INCLUDING its
    contraction-order choice (pallas_crop.py:168-191): nearest selection
    contracts columns first whenever win_h <= win_w (true for all default
    banded windows), making the dots (win_h, win_w) @ (win_w, dw) then
    (dh, win_h) @ (win_h, dw); otherwise — and always for the bilinear
    two-tap selectors, whose rows-then-cols order matches the XLA twin —
    rows first: (dh, win_h) @ (win_h, win_w) then (dh, win_w) @ (dw,
    win_w)^T.  Either way both dots run as THREE one-pass bf16 passes
    (the exact value-side bf16x3 split for nearest, ops/exact_mxu.py;
    HIGHEST's 3-pass lowering for bilinear, docs/ROADMAP.md round-3
    findings), so the executed-flop multiplier is 3.
    """
    if bilinear or win_h > win_w:
        first = 2.0 * dh * win_h * win_w
        second = 2.0 * dh * dw * win_w
    else:
        first = 2.0 * win_h * win_w * dw
        second = 2.0 * dh * win_h * dw
    return batch * 3.0 * (first + second)


def mfu_pct(flops: float, seconds: float, peak_tf: Optional[float]):
    """Model-flops-utilization percentage, or None when peak is unknown."""
    if not peak_tf or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peak_tf * 1e12)


def roofline_ms(n_bytes: float, fp32_ops: float = 0.0, device=None):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``fp32_ops`` float32 operations outside the tensor cores: the
    larger of n_bytes over the memory peak and fp32_ops over the float32
    peak.  Returns (ms, 'bytes' or 'operations', whichever bounds it).
    Raises on the CPU and for a card not in ``_PEAKS``."""
    hbm, fp32 = peak_hbm_tbps(device), peak_fp32_tflops(device)
    if hbm is None or fp32 is None:
        raise RuntimeError("roofline_ms: no peak known for this device; add its "
                           "row to deepprior_tpu_torch/utils/flops.py::_PEAKS")
    t_bytes = n_bytes / (hbm * 1e12) * 1e3
    t_ops = fp32_ops / (fp32 * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct_per_row(idx):
    """The number of distinct non-negative values in each row of ``idx``
    (negative entries mark no read): the byte models count each source
    pixel a kernel reads once."""
    s = torch.sort(idx, dim=1).values
    new = (s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)
    return new.sum(dim=1) + (s[:, 0] >= 0)

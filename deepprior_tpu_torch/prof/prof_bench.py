"""The band-read probes K6 on the card (counterpart of prof_bench.py).

    python -m deepprior_tpu_torch.prof.prof_bench

The TPU probe's shapes and seed: B = 512 frames of 480x640 float32 from
numpy ``default_rng(0)``, the 304x512 band at offsets (0, 0).  Each body
(the band's corner copied out, K6a; band[64, 32] selected exactly, K6b;
the same rounded to bf16, K6c) is timed alone by ``kernel_ms``, a CUDA
graph of 40 launches, so that the time is the card's and not the host's
dispatch.  Each line also gives the card's name and power limit, the
bytes the kernel moves (what the function needs: the kernels read no
band) with the TB/s achieved on them and the roofline share, and, as a
separate figure, the bytes the TPU probe's band DMA moves.  Runs on the
card and raises without one.
"""

from __future__ import annotations

import numpy as np
import torch

from deepprior_tpu_torch.ops import hopper_probes as hp
from deepprior_tpu_torch.utils.flops import peak_hbm_tbps, roofline_ms
from deepprior_tpu_torch.utils.profiling import card_label, kernel_ms, require_cuda

B, H, W = 512, 480, 640
WH, WW = 304, 512
LABELS = {
    "trivial": "band DMA + trivial body",
    "select": "band DMA + 2 HIGHEST matmuls",
    "select_bf16": "band DMA + 2 DEFAULT matmuls",
}


def make_inputs(device):
    """The probe's frames (B, H, W) and zero band offsets (B, 2) int32 on
    ``device``, from numpy ``default_rng(0)`` as the TPU probe makes them."""
    rng = np.random.default_rng(0)
    dpt = torch.from_numpy(rng.random((B, H, W)).astype(np.float32) * 1000).to(device)
    offsets = hp.check_offsets(np.zeros((B, 2), np.float32), (H, W), (WH, WW))
    return dpt, torch.from_numpy(offsets).to(device)


def report(body, ms, card, shape, band):
    """One probe line: ms and us/sample as the TPU probe prints them, then
    the card, the bytes the kernel moves with its TB/s and roofline share,
    and the TPU band's bytes."""
    moved = hp.band_need_bytes(shape, body)
    ops = hp.FP32_OPS_PER_PIXEL[f"band_{body}"] * shape[0] * hp.CORNER ** 2
    bound, bound_by = roofline_ms(moved, ops)
    tbps = moved / (ms * 1e-3) / 1e12
    return (f"{LABELS[body]}: {ms:.4f} ms = {ms * 1000 / shape[0]:.3f} us/sample "
            f"(kernel alone, CUDA graph) [{card}]; moves {moved / 1e6:.1f} MB at "
            f"{tbps:.3f} TB/s ({tbps / peak_hbm_tbps():.1%} of the card's peak): bound "
            f"{bound:.4f} ms by {bound_by}, roofline share {bound / ms:.1%}; the TPU "
            f"probe's band DMA moves {hp.band_read_bytes(shape, band) / 1e6:.1f} MB")


def main(iters: int = 40, log=print):
    """Times K6a, K6b and K6c alone; returns {body: kernel ms}."""
    dev = require_cuda("prof_bench")
    card = card_label(dev)
    dpt, offsets = make_inputs(dev)
    results = {}
    for body in LABELS:
        ms = kernel_ms(lambda d, o, body=body: hp.launch_band(d, o, (WH, WW), body),
                       (dpt, offsets), iters=iters)
        log(report(body, ms, card, tuple(dpt.shape), (WH, WW)))
        results[body] = ms
    return results


if __name__ == "__main__":
    main()

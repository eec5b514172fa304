"""The general nearest warp K7 on the card (counterpart of prof_warp_bf16.py).

    python -m deepprior_tpu_torch.prof.prof_warp_bf16

The TPU probe's shapes and seed: B = 128 patches of 128x128 float32 in
[400, 900) and 128 rotations about the centre, from numpy
``default_rng(0)``.  Times K7 'f32' and 'split' twice: with the inverse
from ``inv3x3`` computed in each call, as the TPU probe's jitted program
does, by ``time_batched_inference`` over 50 eager calls (CUDA events, so
the host's dispatch is included); and the kernel alone by ``kernel_ms``,
a CUDA graph of 50 launches, which times the card.  Prints the max |f32 -
split| as the TPU probe does.  Each line also gives the card's name and
power limit, the bytes, and the TB/s and roofline share of the kernel
alone.  Runs on the card and raises without one.
"""

from __future__ import annotations

import numpy as np
import torch

from deepprior_tpu_torch.ops import hopper_probes as hp
from deepprior_tpu_torch.ops.hopper_warp import warp_bytes, warp_patch_params
from deepprior_tpu_torch.utils.flops import roofline_ms
from deepprior_tpu_torch.utils.profiling import (
    card_label, kernel_ms, require_cuda, time_batched_inference)

B, H, W = 128, 128, 128
LABELS = {False: "general, f32 HIGHEST", True: "general, bf16x3 manual"}


def make_inputs(device):
    """The probe's patches (B, H, W) and forward rotations m (B, 3, 3) on
    ``device``, from numpy ``default_rng(0)`` as the TPU probe makes them."""
    rng = np.random.default_rng(0)
    patch = rng.uniform(400, 900, (B, H, W)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    c, s = np.cos(th), np.sin(th)
    m = np.zeros((B, 3, 3), np.float32)
    m[:, 0, 0] = c
    m[:, 0, 1] = s
    m[:, 1, 0] = -s
    m[:, 1, 1] = c
    m[:, 0, 2] = 64 - 64 * c - 64 * s
    m[:, 1, 2] = 64 + 64 * s - 64 * c
    m[:, 2, 2] = 1
    return torch.from_numpy(patch).to(device), torch.from_numpy(m).to(device)


def report(split, ms, alone_ms, card, params, hw):
    """One probe line: ms and us/sample with inv3x3 and dispatch, as the
    TPU probe prints them, the kernel alone, the card, the bytes, TB/s and
    the roofline share."""
    b = params.shape[0]
    n_bytes = warp_bytes(params, hw)
    ops = hp.FP32_OPS_PER_PIXEL["warp_general_split" if split else "warp_general"]
    bound, bound_by = roofline_ms(n_bytes, ops * b * hw[0] * hw[1])
    return (f"{LABELS[split]:28s}: {ms:7.3f} ms ({ms / b * 1e3:6.2f} us/sample) "
            f"with inv3x3 and dispatch (CUDA events); kernel alone {alone_ms:.4f} ms "
            f"(CUDA graph) [{card}]; needs {n_bytes / 1e6:.2f} MB: "
            f"{n_bytes / (alone_ms * 1e-3) / 1e12:.3f} TB/s, bound {bound:.4f} ms by "
            f"{bound_by}, roofline share {bound / alone_ms:.1%}")


def main(iters: int = 50, log=print):
    """Times K7 'f32' and 'split'; returns ({split: (ms with inv3x3 and
    dispatch, kernel ms alone)}, max |f32 - split|)."""
    dev = require_cuda("prof_warp_bf16")
    card = card_label(dev)
    patch, m = make_inputs(dev)
    params = warp_patch_params(m)
    results, outs = {}, {}
    for split in LABELS:
        ms = time_batched_inference(
            lambda p, mm, split=split: hp.warp_general(p, mm, split), (patch, m), iters)
        alone_ms = kernel_ms(lambda p, prm, split=split: hp.launch_warp_general(p, prm, split),
                             (patch, params), iters)
        outs[split] = hp.warp_general(patch, m, split)
        log(report(split, ms, alone_ms, card, params, tuple(patch.shape[1:])))
        results[split] = (ms, alone_ms)
    diff = (outs[False] - outs[True]).abs().max().item()
    log(f"max diff: {diff}")
    return results, diff


if __name__ == "__main__":
    main()

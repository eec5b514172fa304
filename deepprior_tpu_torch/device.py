"""Where the port runs and in what precision: the two rules every layer
shares, kept below the layers that use them (this module imports only
torch).

- ``default_device``: the entry points' and importers' default device is
  the CUDA card; the CPU is only ever asked for.
- ``float32_compute``: a float32 model computes in float32 on the card,
  with no TF32 in cuDNN's convs or cuBLAS's matmuls, whichever of
  PyTorch's two TF32 APIs the caller's settings went through
  (``_tf32_switches``).
"""

from __future__ import annotations

import contextlib

import torch


def default_device() -> torch.device:
    """The entry points' default device: the CUDA card.  Raises
    RuntimeError when there is none; the CPU is only ever asked for
    (``--device cpu``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "--device cpu to run on the CPU"
        )
    return torch.device("cuda")


def _tf32_switches():
    """The process's TF32 switches for cuDNN's convs and cuBLAS's matmuls,
    and the value that turns each off.  torch >= 2.9 keeps one TF32 state
    per backend and lets two APIs write it: ``fp32_precision`` and the
    legacy ``allow_tf32``.  Once the new API holds a value the legacy flag
    cannot express, reading the legacy flag raises, so the switches are
    read and written through ``fp32_precision`` wherever this torch has it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(cudnn, "conv", None)
    if hasattr(matmul, "fp32_precision") and hasattr(conv, "fp32_precision"):
        return ((conv, "fp32_precision"), (matmul, "fp32_precision")), "ieee"
    return ((cudnn, "allow_tf32"), (matmul, "allow_tf32")), False


@contextlib.contextmanager
def float32_compute():
    """float32 means float32 on the card too: inside the block cuDNN's convs
    and cuBLAS's matmuls do not round their inputs to TF32 (cuDNN does by
    default), and the caller's settings come back after it, whichever of
    PyTorch's two TF32 APIs the caller set them through."""
    switches, off = _tf32_switches()
    saved = [getattr(obj, attr) for obj, attr in switches]
    for obj, attr in switches:
        setattr(obj, attr, off)
    try:
        yield
    finally:
        for (obj, attr), value in zip(switches, saved):
            setattr(obj, attr, value)

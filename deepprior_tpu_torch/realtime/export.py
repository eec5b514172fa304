"""Frozen serving artifacts: the fused pipeline as one program (counterpart
of deepprior_tpu/realtime/export.py).

The reference ships serving as Python source plus a weights pickle and
builds its graph in every new process.  Here the fixed-config pipeline
(``FusedEstimator._pipeline``: clamp, crop, normalize, regress, PCA decode,
denormalize) is frozen into one file that needs no model class, camera
table or prior to serve:

- ``export_serving`` traces the pipeline with ``torch.export`` into an
  ExportedProgram, the trained weights and the prior baked in as its
  constants.  The crop is the registered operator
  ``torch.ops.deepprior_tpu_torch.normalized_crop`` (ops/hopper_crop.py),
  so the program calls the hand-written kernel K1/K2 on a card; loading
  imports that module first, so that the operator is registered.  The
  program holds the device it was exported on: export on the device that
  serves, or move it at load time (``load_serving(device=...)``).  On a
  card the loaded program is captured into one CUDA graph at the
  artifact's batch and replayed.  The kind keeps the JAX package's name,
  ``stablehlo``, so that scripts carry over; it is an exported program,
  not StableHLO.
- ``precompile_serving`` writes the same program as the ``compiled`` kind,
  pinned to the device type and card name it was written on, as the JAX
  executable is pinned to its backend: ``load_precompiled`` loads it as
  ``load_serving`` does, and raises on another card name.

Artifact layout: MAGIC | meta length (8 LE) | meta JSON | payload, the
payload being ``torch.export.save``'s bytes.  The port's MAGIC differs
from the JAX package's, so either package refuses the other's artifacts
with a message.
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepprior_tpu_torch.device import float32_compute
from deepprior_tpu_torch.realtime.fused import Captured, capture_graph, replay_fn

MAGIC = b"DPTTX1\x00\x00"
_JAX_MAGIC = b"DPTPUX1\x00"


def _write(path: str, meta: Dict[str, Any], payload: bytes) -> None:
    blob = json.dumps(meta, sort_keys=True).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        f.write(payload)
    os.replace(tmp, path)


def _read(path: str) -> Tuple[Dict[str, Any], bytes]:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            if magic == _JAX_MAGIC:
                raise ValueError(
                    f"{path} is a JAX (deepprior_tpu) serving artifact; the "
                    "PyTorch port reads only its own: re-export it with "
                    "deepprior_tpu_torch.realtime.export")
            raise ValueError(f"{path} is not a deepprior_tpu_torch serving artifact")
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        return meta, f.read()


class _Frozen(torch.nn.Module):
    """The estimator's fixed-config pipeline as a module: what is traced (the
    live estimator's counters left out)."""

    def __init__(self, est):
        super().__init__()
        self.est = copy.copy(est)
        self.est.stats = None
        self.model = est.model  # its weights become the program's parameters

    def forward(self, depth, com):
        return self.est._pipeline(depth, com)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _export(est, batch: int, hw: Tuple[int, int]) -> Tuple[bytes, Dict[str, Any]]:
    if not est.family.freezes:
        raise ValueError(f"a serving artifact freezes a crop regressor's pipeline; a "
                         f"{type(est.model).__name__} is not supported: serve it from its "
                         f"checkpoint through the estimator")
    dev = est.device
    depth = torch.zeros((batch, *hw), dtype=torch.float32, device=dev)
    com = torch.zeros((batch, 3), dtype=torch.float32, device=dev)
    with torch.no_grad():
        program = torch.export.export(_Frozen(est), (depth, com), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "batch": int(batch),
        "hw": [int(v) for v in hw],
        "device": str(dev),
        "dsize": list(est.dsize),
        "cube": [float(v) for v in est.cube.reshape(-1).tolist()],
        "num_outputs": 3,  # (joints3d_mm, com3d, crops)
        "torch_version": torch.__version__,
    }
    return buf.getvalue(), meta


def export_serving(est, batch: int, hw: Tuple[int, int], path: str) -> Dict[str, Any]:
    """Freeze ``est._pipeline`` (the constructor's cube, no mirror, the
    weights baked in) for a static (batch, H, W) on ``est.device`` into an
    exported-program artifact (kind ``stablehlo``).  Returns the meta,
    which the file stores too."""
    payload, meta = _export(est, batch, hw)
    meta["kind"] = "stablehlo"
    _write(path, meta, payload)
    return meta


def _load_program(payload: bytes):
    # the exported program calls the crop operator by name
    import deepprior_tpu_torch.ops.hopper_crop  # noqa: F401

    return torch.export.load(io.BytesIO(payload))


def _load(meta: Dict[str, Any], payload: bytes, device):
    """(fn, meta) over the artifact's program on ``device`` (default the
    artifact's; another device moves the program with
    ``torch.export.passes.move_to_device_pass``).  The program runs under
    ``float32_compute``: a float32 model is float32 on the card too.  On a
    card fn replays one CUDA graph of the program at the artifact's batch
    (``replay_fn``: inputs copied in, clones out); elsewhere it calls the
    program."""
    program = _load_program(payload)
    target = torch.device(meta["device"] if device is None else device)
    if target != torch.device(meta["device"]):
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, target)
        meta = dict(meta, device=str(target))
    module = program.module()

    def run(depth, com):
        with float32_compute():
            return module(depth, com)

    if target.type == "cuda":
        b, hw = int(meta["batch"]), tuple(meta["hw"])
        with torch.inference_mode():
            depth = torch.zeros((b, *hw), dtype=torch.float32, device=target)
            com = torch.zeros((b, 3), dtype=torch.float32, device=target)
            graph, outputs = capture_graph(lambda: run(depth, com), target)
        return replay_fn(Captured(graph, depth, com, None, None, tuple(outputs),
                                  module)), meta

    def fn(depth, com):
        with torch.inference_mode():
            return run(torch.as_tensor(depth, dtype=torch.float32, device=target),
                       torch.as_tensor(com, dtype=torch.float32, device=target))

    return fn, meta


def load_serving(path: str, device=None):
    """Load an artifact written by ``export_serving``.

    Returns (fn, meta): fn(depth (B, H, W) float32 raw mm, com (B, 3) image
    coords) -> (joints3d_mm, com3d, crops), on the program's device; the
    inputs may be numpy arrays or tensors.  ``device`` moves the program
    to another device (``_load``)."""
    meta, payload = _read(path)
    if meta.get("kind") != "stablehlo":
        raise ValueError(
            f"{path} is a {meta.get('kind')} artifact; load_serving reads "
            "stablehlo (exported-program) artifacts (use load_precompiled "
            "for compiled ones)"
        )
    return _load(meta, payload, device)


def precompile_serving(est, batch: int, hw: Tuple[int, int], path: str) -> Dict[str, Any]:
    """Write the exported program as the ``compiled`` kind: pinned to the
    device type and card name of ``est.device`` (``load_precompiled``).
    Returns the meta."""
    payload, meta = _export(est, batch, hw)
    meta.update(kind="compiled", device_type=est.device.type,
                device_name=_device_name(est.device))
    _write(path, meta, payload)
    return meta


def load_precompiled(path: str, device=None):
    """Load a ``compiled`` artifact on the device type and card name it was
    written on (``device``, default the artifact's), as ``load_serving``
    loads the exported kind; another device type or card name raises.
    Returns (fn, meta)."""
    meta, payload = _read(path)
    if meta.get("kind") != "compiled":
        raise ValueError(
            f"{path} is a {meta.get('kind')} artifact; load_precompiled "
            "reads compiled artifacts (use load_serving for stablehlo)"
        )
    dev = torch.device(meta["device"] if device is None else device)
    if dev.type != meta["device_type"] or (
            dev.type == "cuda" and not torch.cuda.is_available()):
        raise ValueError(
            f"compiled for {meta['device_type']!r}, asked to run on {str(dev)!r}: "
            "re-export or use the stablehlo artifact")
    if _device_name(dev) != meta["device_name"]:
        raise ValueError(
            f"compiled on {meta['device_name']!r}, running on {_device_name(dev)!r}: "
            "re-export or use the stablehlo artifact")
    return _load(meta, payload, dev)


def load_artifact(path: str, device=None):
    """Load either artifact kind by its stored meta."""
    meta, _ = _read(path)
    if meta.get("kind") == "compiled":
        return load_precompiled(path, device)
    return load_serving(path, device)


class ArtifactEstimator:
    """Serving shim around a loaded artifact with the micro-batcher's
    fixed-config calling convention (realtime/batcher.py):
    ``est(depth, com) -> (joints3d_mm, com3d, crops)``.

    The artifact's config is frozen (the constructor's cube, no per-request
    mirror) and its batch is the exported shape: pass ``max_batch=
    est.batch`` and ``frame_shape=est.hw`` to MicroBatchServer."""

    def __init__(self, path: str, device: Optional[str] = None):
        self._fn, self.meta = load_artifact(path, device)
        self.batch = int(self.meta["batch"])
        self.hw = tuple(self.meta["hw"])
        self.device = torch.device(self.meta["device"])
        self.cube = np.asarray(self.meta["cube"], np.float32)

    def __call__(self, depth, com):
        return self._fn(depth, com)

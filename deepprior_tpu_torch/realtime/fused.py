"""The fused inference pipeline: depth frames -> 3D joints, on one device.

Counterpart of deepprior_tpu/realtime/fused.py.  Per batch:

  clamp -> (optional CoM detection / iterative refinement) -> cube crop +
  normalize -> PoseRegNet -> (optional PCA decode) -> mirror / flip ->
  denormalize (pose * cube_z/2 + com3D)

On a CUDA device the crop and normalize are one launch of the hand-written
kernel (ops/hopper_crop.py): K1 for the nearest resize, K2 for 'linear',
with the clamp fused into it when there is no detection, and on the
clamped frame after it, through the registered operator
``torch.ops.deepprior_tpu_torch.normalized_crop``.  'nd_bilinear' has no
kernel in either package and runs the plain crop.  On the CPU every step
is the plain PyTorch of ops/crop.py and ops/com.py.

``__call__`` runs the pipeline eagerly.  ``aot_compile(batch, hw)``, the
counterpart of the JAX estimator's ahead-of-time compile, captures it into
one CUDA graph over static device buffers and returns a callable that
copies its inputs in and replays the graph: the host dispatches one
replay instead of each operation.  ``MicroBatchServer`` replays the same
capture (``_capture``) with per-request cube and mirror.  Every mode
captures: the detection (``ops/com.py::detect_closest``) and the refinement
(``refine_com_iterative``) are fixed counts of tensor operations with no
read back to the host, and 'nd_bilinear' is the plain gather.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.device import float32_compute
from deepprior_tpu_torch.ops.com import detect_closest, refine_com_iterative
from deepprior_tpu_torch.ops.crop import RESIZE_METHODS, clamp_depth, normalized_crop
from deepprior_tpu_torch.ops.hopper_crop import normalized_crop_op
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.utils.profiling import graph_capture

_CROP_METHODS = ("auto", "pallas", "hopper", "gather", "onehot")


class Captured(NamedTuple):
    """One CUDA graph of the pipeline over static device buffers: write the
    inputs into ``depth``, ``com``, ``cube`` and ``mirror`` (on the device,
    under ``torch.inference_mode``), replay ``graph``, and read ``outputs``
    (joints, com3d, crops), which the next replay overwrites.  The graph
    reads the buffers' memory and ``owner``'s tensors (the weights), so
    whoever replays it holds this tuple: memory freed and reallocated would
    feed the next replay garbage."""

    graph: "torch.cuda.CUDAGraph"
    depth: torch.Tensor   # (B, H, W) raw mm
    com: torch.Tensor     # (B, 3) image coords
    cube: Optional[torch.Tensor]    # (B, 3) mm, the constructor's cube until written
    mirror: Optional[torch.Tensor]  # (B,) bool, False until written
    outputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    owner: object         # the estimator or program whose weights the graph reads


class FusedEstimator:
    """Applies the frame -> pose pipeline to batches.

    ``model`` is an ``nn.Module`` that holds its weights and maps
    (B, 1, dh, dw) crops to (B, out) embeddings or poses.  ``device``
    defaults to the model's; the model and prior move to it.  A float32
    model computes in float32 on the card too, whatever the process's TF32
    switches say (``float32_compute``: no TF32 convs), and so does a graph
    captured of it.

    crop_method: 'auto' takes the CUDA kernel on a CUDA device and the
    plain gather on the CPU; 'pallas' (the JAX package's name) and
    'hopper' name the kernel path; 'gather' and 'onehot' force the plain
    path.  min_depth_mm set the TPU kernel's window height and has no
    effect here.

    detect: find the CoM on the device (``ops.com.detect_closest``) and
    ignore the ``com`` passed in; refine_iters > 0: refine the passed CoM
    that many times (``refine_com_iterative``).  Both run on the clamped
    frames, with each image's clamp limits.

    resize: the reference's resize-method switch (handdetector.py:57-69),
    None/'nearest', 'linear' or 'nd_bilinear'.  One routing difference
    from the JAX estimator: it sends 'linear' to its XLA one-hot crop,
    while the kernel path here runs the cv2-linear kernel K2; both compute
    the same crop to float32 round-off.

    A model of a family that trains on one device only (``one_device_only``:
    V2V-PoseNet) is refused with ValueError: the estimator, and the
    pipeline and server built on it, serve the crop regressors.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        camera: Camera,
        cube=(250.0, 250.0, 250.0),
        prior: Optional[PCAPrior] = None,
        num_joints: Optional[int] = None,
        dsize=(128, 128),
        refine_iters: int = 0,
        detect: bool = False,
        crop_method: str = "auto",
        min_depth_mm: Optional[float] = None,
        resize: Optional[str] = None,
        device=None,
    ):
        if resize is not None and resize not in RESIZE_METHODS:
            raise ValueError(f"unknown resize method {resize!r}")
        if getattr(model, "one_device_only", False):
            raise ValueError(f"FusedEstimator does not take a {type(model).__name__}: its "
                             f"family trains on one device only; serving it is not supported")
        if crop_method not in _CROP_METHODS:
            raise ValueError(f"unknown crop method {crop_method!r}")
        if device is None:
            device = next(model.parameters()).device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        self.model = model.to(self.device).eval()
        self.camera = camera
        self.cube = torch.as_tensor(cube, dtype=torch.float32, device=self.device)
        self.prior = None if prior is None else prior.to(self.device)
        self.num_joints = num_joints
        self.dsize = tuple(dsize)
        self.refine_iters = refine_iters
        self.detect = detect
        self.resize = resize or "nearest"
        if crop_method == "auto":
            crop_method = "hopper" if self.device.type == "cuda" else "gather"
        elif crop_method == "pallas":
            crop_method = "hopper"
        self.crop_method = crop_method

    # ------------------------------------------------------------------
    def _pipeline(self, depth, com):
        """Fixed-config entry: the constructor's cube, no mirroring."""
        b = depth.shape[0]
        return self._pipeline_cfg(
            depth, com, self.cube.expand(b, 3),
            torch.zeros(b, dtype=torch.bool, device=self.device),
        )

    def _pipeline_cfg(self, depth, com, cube, mirror, invx=False, invy=False):
        """depth (B, H, W) raw mm, com (B, 3) image coords, cube (B, 3) mm
        (the live per-sample cube reaches both the crop and the
        denormalization), mirror (B,) bool: right-hand crops are mirrored
        into the net and the x of the relative pose is flipped back.
        invx/invy flip the relative pose's index 1/0 respectively, the
        reference's swapped-index quirk (realtimehandpose:353-363).

        Returns (joints3d_mm (B, J, 3), com3d (B, 3), crops (B, dh, dw))."""
        cam = self.camera
        kernel = self.crop_method == "hopper" and self.resize != "nd_bilinear"
        clamped = False
        if self.detect or self.refine_iters or not kernel:
            depth, dmin, dmax = clamp_depth(depth)
            clamped = True
            if self.detect:
                com = detect_closest(depth, cube, cam.fx, cam.fy,
                                     min_depth=dmin, max_depth=dmax)
            elif self.refine_iters:
                com = refine_com_iterative(
                    depth, com, cube, cam.fx, cam.fy, self.refine_iters,
                    min_depth=dmin, max_depth=dmax,
                )
        if kernel:
            # without detection the kernel applies the clamp to the pixels
            # it reads: no full-frame clean pass
            dw, dh = self.dsize
            crops, _ = normalized_crop_op(
                depth, com, cube, float(cam.fx), float(cam.fy), dw, dh, False,
                not clamped, self.resize == "linear",
            )
        else:
            # 'nd_bilinear' on the kernel route takes the plain gather
            method = "onehot" if self.crop_method == "onehot" else "gather"
            crops, _ = normalized_crop(
                depth, com, cube, cam.fx, cam.fy, self.dsize,
                method=method, resize=self.resize,
            )
        net_in = torch.where(mirror[:, None, None], crops.flip(-1), crops)
        with float32_compute():  # a float32 model: no TF32 convs on the card
            out = self.model(net_in[:, None])
        if self.prior is not None:
            out = self.prior.inverse_transform(out)
        pose = out.reshape(out.shape[0], -1, 3)
        # relative-pose sign flips, in the reference's order and indices
        flip = torch.ones((pose.shape[0], 3), dtype=torch.float32, device=pose.device)
        if invx:  # reference invX flips index 1 (realtimehandpose:355-358)
            flip[:, 1] = -1.0
        if invy:  # reference invY flips index 0 (:360-363)
            flip[:, 0] = -1.0
        # un-mirror the x of mirrored (right-hand) poses (:366-369)
        flip[:, 0] = flip[:, 0] * torch.where(mirror, -1.0, 1.0)
        pose = pose * flip[:, None, :]
        com3d = cam.img_to_3d(com)
        joints = pose * (cube[:, 2] / 2.0)[:, None, None] + com3d[:, None, :]
        return joints, com3d, crops

    @torch.inference_mode()
    def __call__(self, depth, com=None, cube=None, mirror=None,
                 invx=False, invy=False):
        """depth (B, H, W) raw mm; com (B, 3) image coords (ignored with
        ``detect``); cube (3,) or (B, 3) mm, default the constructor's;
        mirror bool or (B,) bool.  Inputs may be numpy arrays or tensors;
        they move to the device."""
        dev = self.device
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        b = depth.shape[0]
        if com is None:
            com = torch.zeros((b, 3), dtype=torch.float32, device=dev)
        com = torch.as_tensor(com, dtype=torch.float32, device=dev)
        if cube is None and mirror is None and not invx and not invy:
            return self._pipeline(depth, com)
        cb = self.cube if cube is None else torch.as_tensor(
            cube, dtype=torch.float32, device=dev)
        cb = cb.expand(b, 3)
        if mirror is None:
            mr = torch.zeros(b, dtype=torch.bool, device=dev)
        else:
            mr = torch.as_tensor(mirror, dtype=torch.bool, device=dev).expand(b)
        return self._pipeline_cfg(depth, com, cb, mr, invx=invx, invy=invy)

    # ------------------------------------------------------------------
    @property
    def captures(self) -> bool:
        """Whether ``aot_compile`` and ``MicroBatchServer`` replay a CUDA
        graph of this estimator: on a CUDA device, in every mode."""
        return self.device.type == "cuda"

    def _capture(self, batch: int, hw) -> Captured:
        """Capture ``_pipeline_cfg`` at (batch, *hw) into one CUDA graph
        (``capture_graph``).  The static buffers are allocated on the
        device under ``torch.inference_mode`` (write them under it too);
        the cube starts as the constructor's and mirror as False."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA estimator, not {self.device}")
        dev = self.device
        with torch.inference_mode():
            f32 = dict(dtype=torch.float32, device=dev)
            depth = torch.zeros((batch, *hw), **f32)
            com = torch.zeros((batch, 3), **f32)
            cube = self.cube.expand(batch, 3).clone()
            mirror = torch.zeros(batch, dtype=torch.bool, device=dev)
            graph, outputs = capture_graph(
                lambda: self._pipeline_cfg(depth, com, cube, mirror), dev)
        return Captured(graph, depth, com, cube, mirror, tuple(outputs), self)

    def aot_compile(self, batch: int, hw):
        """Counterpart of the JAX estimator's ``aot_compile(variables, batch,
        hw)``: the fixed configuration (the constructor's cube, no mirror)
        at a fixed (batch, H, W), made ready ahead of the first frame.

        Returns ``fn(depth (batch, H, W), com (batch, 3)) -> (joints3d_mm,
        com3d, crops)``; the inputs may be numpy arrays or tensors.  On a
        CUDA estimator fn replays one CUDA graph (``_capture``,
        ``replay_fn``): it returns clones that the caller owns, so a later
        call does not overwrite an earlier result, and calls from several
        threads take turns.  On a CPU estimator fn checks the shapes and
        runs the pipeline.  Every mode compiles, as in the JAX package."""
        batch, hw = int(batch), tuple(int(v) for v in hw)
        if self.device.type == "cuda":
            return replay_fn(self._capture(batch, hw))

        def fn(depth, com):
            depth, com = fixed_inputs(depth, com, (batch, *hw))
            with torch.inference_mode():
                return self._pipeline(depth, com)

        return fn


def capture_graph(fn, device):
    """One CUDA graph of ``fn()`` on ``device``: one warm-up call on a side
    stream first, outside the capture (a first call builds the crop kernel
    with nvcc and sets its attributes, which a capture cannot do).  Returns
    (graph, fn's outputs in the graph's memory).  A failed capture raises:
    there is no eager fallback."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph):
            outputs = fn()
    return graph, outputs


def fixed_inputs(depth, com, shape):
    """depth and com as float32 tensors on their devices, checked against
    the fixed (B, H, W) ``shape`` they were compiled for."""
    depth = torch.as_tensor(depth, dtype=torch.float32)
    com = torch.as_tensor(com, dtype=torch.float32)
    if tuple(depth.shape) != tuple(shape) or tuple(com.shape) != (shape[0], 3):
        raise ValueError(f"compiled for depth {tuple(shape)} and com {(shape[0], 3)}, "
                         f"got {tuple(depth.shape)} and {tuple(com.shape)}")
    return depth, com


def replay_fn(cap: Captured):
    """``fn(depth, com)`` over a captured graph (its cube and mirror, where
    it has them, stay as they are): checks the shapes, copies the inputs
    into the static buffers, replays, and returns clones of the outputs
    that the caller owns.  fn holds ``cap``, and with it every buffer and
    weight the graph reads.  Calls from several threads take turns: one
    lock holds the copy in, the replay and the clones."""
    shape = tuple(cap.depth.shape)
    lock = threading.Lock()

    def fn(depth_in, com_in):
        depth_in, com_in = fixed_inputs(depth_in, com_in, shape)
        with lock, torch.inference_mode():
            cap.depth.copy_(depth_in, non_blocking=True)
            cap.com.copy_(com_in, non_blocking=True)
            cap.graph.replay()
            return tuple(t.clone() for t in cap.outputs)

    return fn

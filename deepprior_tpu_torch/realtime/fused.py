"""The fused inference pipeline: depth frames -> 3D joints, on one device.

Counterpart of deepprior_tpu/realtime/fused.py.  Per batch:

  clamp -> (optional CoM detection / iterative refinement) -> cube crop +
  normalize -> the family's inputs -> mirror -> the network -> the
  family's joints about the CoM -> flips -> + com3D

The model's family (models/family.py::family_of) decides the middle: a
crop regressor (PoseRegNet, ResNet) takes the crop, mirrored along its
width, and its output is decoded through the optional PCA prior and scaled
by cube_z/2; V2V-PoseNet takes the occupancy grid of the crop
(ops/voxel.py::voxelize, from the crop transform the crop returns),
mirrored along x, and its heatmaps are decoded at their argmax voxels.

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
capture (``_capture``), one for each row count over one set of static
buffers, with per-request cube and mirror.  Every mode
captures: the detection (``ops/com.py::detect_closest``) and the refinement
(``refine_com_iterative``) are fixed counts of tensor operations with no
read back to the host, and 'nd_bilinear' is the plain gather.

``stats`` holds the estimator's counters, 0-d int64 tensors on its device
added to inside every call and every replay with no host sync: ``rows``
(rows computed, padding included) and, for V2V-PoseNet, ``voxels_set``
and ``voxels_seen`` (the grids' occupied and offered voxels).  An
estimator whose ``stats`` is None counts nothing (a frozen program's
trace, realtime/export.py).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.device import float32_compute
from deepprior_tpu_torch.models.family import family_of
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
    (``_pipeline_cfg``'s), which the next replay overwrites.  The graph
    reads the buffers' memory and ``owner``'s tensors (the weights), so
    whoever replays it holds this tuple: memory freed and reallocated would
    feed the next replay garbage."""

    graph: "torch.cuda.CUDAGraph"
    depth: torch.Tensor   # (B, H, W) raw mm
    com: torch.Tensor     # (B, 3) image coords
    cube: Optional[torch.Tensor]    # (B, 3) mm, the constructor's cube until written
    mirror: Optional[torch.Tensor]  # (B,) bool, False until written
    outputs: Tuple[torch.Tensor, ...]
    owner: object         # the estimator or program whose weights the graph reads


class FusedEstimator:
    """Applies the frame -> pose pipeline to batches.

    ``model`` is an ``nn.Module`` that holds its weights: a crop regressor
    mapping (B, 1, dh, dw) crops to (B, out) embeddings or poses, or a
    model that brings its family's choices (V2V-PoseNet: grids to heatmaps;
    models/family.py).  Either runs in eval mode; a model that is not
    served yet (``serves`` False: A2J) raises ValueError.  ``device``
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
        if crop_method not in _CROP_METHODS:
            raise ValueError(f"unknown crop method {crop_method!r}")
        if not getattr(model, "serves", True):
            raise ValueError(f"{type(model).__name__} is not served yet: the estimator "
                             "takes PoseRegNet, ResNet-47 and V2V-PoseNet")
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
        self.stats = new_stats(self.device)
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

    @property
    def family(self):
        """The model's family (models/family.py), of the model and prior
        this estimator holds now (a replica's copy swaps them)."""
        return family_of(self.model, self.prior)

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

        Returns (joints3d_mm (B, J, 3), com3d (B, 3), crops (B, dh, dw))
        and the family's ``extras`` (V2V-PoseNet: its grids (B, G, G, G)
        before the mirror and its heatmaps (B, J, n, n, n)).  Adds to
        ``stats``."""
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
            crops, m = normalized_crop_op(
                depth, com, cube, float(cam.fx), float(cam.fy), dw, dh, False,
                not clamped, self.resize == "linear",
            )
        else:
            # 'nd_bilinear' on the kernel route takes the plain gather
            method = "onehot" if self.crop_method == "onehot" else "gather"
            crops, m = normalized_crop(
                depth, com, cube, cam.fx, cam.fy, self.dsize,
                method=method, resize=self.resize,
            )
        batch = {"crops": crops, "com": com, "cube": cube, "m": m}
        family = self.family
        x = family.inputs(batch, cam, stats=self.stats)
        if self.stats is not None:
            self.stats["rows"].add_(x.shape[0])
        flipped = mirror.reshape((-1,) + (1,) * (x.dim() - 1))
        net_in = torch.where(flipped, x.flip(family.mirror_dim), x)
        with float32_compute():  # a float32 model: no TF32 convs on the card
            out = self.model(net_in)
        rel = family.joints(out, batch, camera=cam)  # mm about the CoM
        # relative-pose sign flips, in the reference's order and indices
        flip = torch.ones((rel.shape[0], 3), dtype=torch.float32, device=rel.device)
        if invx:  # reference invX flips index 1 (realtimehandpose:355-358)
            flip[:, 1] = -1.0
        if invy:  # reference invY flips index 0 (:360-363)
            flip[:, 0] = -1.0
        # un-mirror the x of mirrored (right-hand) poses (:366-369)
        flip[:, 0] = flip[:, 0] * torch.where(mirror, -1.0, 1.0)
        com3d = cam.img_to_3d(com)
        joints = rel * flip[:, None, :] + com3d[:, None, :]
        return (joints, com3d, crops) + tuple(family.extras(x, out))

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

    def _capture(self, batch: int, hw, over: Optional[Captured] = None) -> Captured:
        """Capture ``_pipeline_cfg`` at (batch, *hw) into one CUDA graph
        (``capture_graph``).  The static buffers are allocated on the
        device under ``torch.inference_mode`` (write them under it too);
        the cube starts as the constructor's and mirror as False.

        With ``over``, a capture at ``batch`` rows or more, the graph reads
        the leading ``batch`` rows of ``over``'s static buffers, writes its
        outputs into the leading rows of ``over``'s and takes its working
        memory from ``over``'s pool, so graphs over one capture hold about
        that capture's memory whatever their number.  They share it: a
        replay of any of them overwrites the others' outputs and working
        memory, so replay them one at a time, on one stream, and read each
        replay's outputs before the next."""
        if not self.captures:
            raise ValueError(f"a CUDA graph needs a CUDA estimator, not {self.device}")
        dev = self.device
        with torch.inference_mode():
            if over is None:
                f32 = dict(dtype=torch.float32, device=dev)
                depth = torch.zeros((batch, *hw), **f32)
                com = torch.zeros((batch, 3), **f32)
                cube = self.cube.expand(batch, 3).clone()
                mirror = torch.zeros(batch, dtype=torch.bool, device=dev)
                graph, outputs = capture_graph(
                    lambda: self._pipeline_cfg(depth, com, cube, mirror), dev)
            else:
                depth, com = over.depth[:batch], over.com[:batch]
                cube, mirror = over.cube[:batch], over.mirror[:batch]
                outputs = tuple(o[:batch] for o in over.outputs)

                def into_over():
                    for out, new in zip(outputs, self._pipeline_cfg(depth, com, cube, mirror)):
                        out.copy_(new)
                    return outputs

                graph, _ = capture_graph(into_over, dev, pool=over.graph.pool())
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


def new_stats(device) -> Dict[str, torch.Tensor]:
    """The estimator's counters, zero, on ``device``."""
    return {k: torch.zeros((), dtype=torch.int64, device=device)
            for k in ("rows", "voxels_set", "voxels_seen")}


def capture_graph(fn, device, pool=None):
    """One CUDA graph of ``fn()`` on ``device``: one warm-up call on a side
    stream first, outside the capture (a first call builds the crop kernel
    with nvcc and sets its attributes, which a capture cannot do).  Returns
    (graph, fn's outputs in the graph's memory).  The graph takes its
    memory from ``pool`` (another graph's ``pool()``) or, by default, a
    pool of its own.  A failed capture raises: there is no eager
    fallback."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph, pool):
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

"""Bulk serving over several devices: the fused frame -> joints pipeline
per device on its share of the batch (counterpart of
deepprior_tpu/parallel/serve.py).

The JAX package serves a batch over a mesh in two ways, and so does this
module:

- data-parallel (``devices``, one process): one ``FusedEstimator`` replica
  per entry of a device list runs the unchanged pipeline, the crop kernel
  K1 included, on its block of the batch, with no collectives (the JAX
  ``shard_map`` mode).  Each replica replays a CUDA graph of its own,
  captured on a stream of its own, so replicas on one card overlap.  The
  device list may repeat a device (two replicas on 'cuda:0'; 'cpu' twice in
  the tests): replicas on one device share its copy of the weights.
- tensor-parallel (``mesh`` with tp > 1, one process per device under a
  process group): the FC stack is split by ``param_shardings``
  (Megatron, models/layers.py::MLPHead), each data-parallel rank crops and
  regresses its rows of the batch (K1 on its own card; only the Linear
  layers are split, so the crop stays the kernel, where the JAX package
  switches to its one-hot crop under GSPMD), and the rows are gathered
  back so every rank returns the whole batch.

The batch must divide the data-parallel size; ``MicroBatchServer`` pads to
its ``max_batch``, a multiple of it.
"""

from __future__ import annotations

import copy
import threading
from typing import List, Optional, Sequence

import torch

from deepprior_tpu_torch.parallel.collectives import all_gather_rows
from deepprior_tpu_torch.parallel.mesh import (
    axis_size, data_groups, data_rank, param_shardings, shard_model)
from deepprior_tpu_torch.realtime.fused import FusedEstimator, fixed_inputs, new_stats


class ShardedEstimator:
    """``est`` scaled over ``devices`` (data-parallel, one process) or over
    ``mesh`` (under a process group; with tp > 1 ``est``'s model is split in
    place, each rank keeping its block of the FC stack).
    ``est``'s configuration (cube, detection, refinement, resize, prior)
    holds in every replica.

    On CUDA replicas (``graph``) each call of a batch shape replays one
    CUDA graph per replica, captured at the first call of that shape;
    ``eager`` runs the same split without graphs."""

    def __init__(self, est: FusedEstimator, devices: Optional[Sequence] = None,
                 mesh=None):
        if devices is not None and mesh is not None:
            raise ValueError("give devices (one process) or mesh (a process group), "
                             "not both")
        if getattr(est.model, "one_device_only", False):
            raise ValueError(f"ShardedEstimator does not take a {type(est.model).__name__}: "
                             f"its family runs on one device only; sharded serving is not "
                             f"supported")
        self.est = est
        self.camera = est.camera
        self.detect = est.detect
        self.mesh = mesh
        if mesh is not None:
            self.replicas = [est]
            self._index, self.dp = data_rank(mesh)
            self._groups = data_groups(mesh)
            tp = axis_size(mesh, "tp")
            if tp > 1:
                shard_model(est.model, param_shardings(est.model, mesh),
                            mesh.get_group("tp"), mesh.get_local_rank("tp"), tp)
            self.graph = False  # collectives between the ranks: eager
        else:
            devices = [est.device] if devices is None else [torch.device(d) for d in devices]
            models = {est.device: est.model}
            self.replicas: List[FusedEstimator] = []
            for dev in devices:
                if dev not in models:
                    models[dev] = copy.deepcopy(est.model).to(dev)
                rep = copy.copy(est)
                rep.model, rep.device = models[dev], dev
                rep.cube = est.cube.to(dev)
                rep.stats = new_stats(dev)
                rep.prior = None if est.prior is None else est.prior.to(dev)
                self.replicas.append(rep)
            self.dp = len(self.replicas)
            self.graph = all(r.captures for r in self.replicas)
        self._graphs = {}
        self._lock = threading.Lock()

    @property
    def devices(self):
        return [r.device for r in self.replicas]

    def _blocks(self, b: int):
        if b % self.dp:
            raise ValueError(f"batch {b} is not a multiple of the {self.dp} data-parallel "
                             "replicas: pad it (the pipeline is per sample, padded "
                             "rows are discarded by the caller)")
        per = b // self.dp
        if self.mesh is not None:
            return [slice(self._index * per, (self._index + 1) * per)]
        return [slice(i * per, (i + 1) * per) for i in range(self.dp)]

    def place_batch(self, depth, com):
        """This process's blocks of a host or device batch, each on its
        replica's device: [(depth (B/dp, H, W), com (B/dp, 3)), ...]."""
        depth = torch.as_tensor(depth, dtype=torch.float32)
        com = torch.as_tensor(com, dtype=torch.float32)
        return [(depth[sl].to(r.device, non_blocking=True), com[sl].to(r.device, non_blocking=True))
                for sl, r in zip(self._blocks(depth.shape[0]), self.replicas)]

    def _com(self, depth, com):
        if com is None:
            if not self.detect:
                # a zeros CoM would crop empty space at the image origin and
                # return plausible-looking garbage joints; only a detecting
                # pipeline recovers the hand from the frame
                raise ValueError("com is required unless the wrapped FusedEstimator "
                                 "was built with detect=True")
            com = torch.zeros((depth.shape[0], 3), dtype=torch.float32)
        return com

    def _join(self, outs):
        """The replicas' (joints, com3d, crops) in order, on the first
        replica's device (gathered over the data ranks under a mesh)."""
        if self.mesh is not None:
            return tuple(all_gather_rows(t, self._groups) for t in outs[0])
        dev = self.replicas[0].device
        return tuple(torch.cat([o[k].to(dev) for o in outs]) for k in range(3))

    @torch.inference_mode()
    def eager(self, depth, com=None):
        """Every replica's ``_pipeline`` on its block, one after the other,
        without graphs."""
        com = self._com(depth, com)
        return self._join([r._pipeline(d, c) for r, (d, c) in
                           zip(self.replicas, self.place_batch(depth, com))])

    def __call__(self, depth, com=None):
        """depth (B, H, W) raw mm, com (B, 3) image coords (None with
        detection).  Returns (joints3d_mm (B, J, 3), com3d (B, 3), crops
        (B, dh, dw)) on the first replica's device, in the batch's order."""
        if not self.graph:
            return self.eager(depth, com)
        com = self._com(depth, com)
        depth = torch.as_tensor(depth, dtype=torch.float32)
        key = tuple(depth.shape)
        with self._lock:
            fn = self._graphs.get(key)
            if fn is None:
                fn = self._graphs[key] = self.aot_compile(key[0], key[1:])
        return fn(depth, com)

    def aot_compile(self, batch: int, hw):
        """One CUDA graph per replica at (batch / dp, *hw), each captured and
        replayed on a stream of its own.  Returns fn(depth (batch, H, W),
        com (batch, 3)) -> the joined outputs, clones the caller owns;
        calls from several threads take turns."""
        if not self.graph:
            raise NotImplementedError("graphs need CUDA replicas whose mode captures, "
                                      "and no process group")
        batch, hw = int(batch), tuple(int(v) for v in hw)
        per = self._blocks(batch)[0].stop
        caps, streams = [], []
        for r in self.replicas:
            stream = torch.cuda.Stream(r.device)
            with torch.cuda.stream(stream):
                caps.append(r._capture(per, hw))
            streams.append(stream)
        lock = threading.Lock()

        def fn(depth, com):
            depth, com = fixed_inputs(depth, com, (batch, *hw))
            with lock, torch.inference_mode():
                for cap, stream, r, sl in zip(caps, streams, self.replicas,
                                              self._blocks(batch)):
                    stream.wait_stream(torch.cuda.current_stream(r.device))
                    with torch.cuda.stream(stream):
                        cap.depth.copy_(depth[sl], non_blocking=True)
                        cap.com.copy_(com[sl], non_blocking=True)
                        cap.graph.replay()
                for stream, r in zip(streams, self.replicas):
                    torch.cuda.current_stream(r.device).wait_stream(stream)
                dev = self.replicas[0].device
                return tuple(torch.cat([cap.outputs[k].to(dev) for cap in caps])
                             for k in range(3))

        return fn

"""Online serving front-end: transparent micro-batching over the fused
estimator.

Counterpart of deepprior_tpu/realtime/batcher.py.  Concurrent callers
submit single frames and get Futures; a collector thread groups up to
``max_batch`` requests (waiting at most ``max_wait_ms`` after the first
arrival), runs the fused pipeline once on them, and resolves every
caller's Future from one copy of the joints back to the host.

On a CUDA estimator whose mode captures (``FusedEstimator.captures``) the
server replays CUDA graphs of the pipeline (``FusedEstimator._capture``),
one for each row count from 1 to ``max_batch``, all over leading slices of
one set of static device buffers and outputs, in one memory pool: it
stacks a batch of n requests into the first n rows of one pinned host
buffer, copies those rows asynchronously into the static buffers, writes
the n requests' cube and mirror, and replays the n-row graph, so the
device computes exactly the batch's rows.
``graph=False`` runs the pipeline eagerly instead, on the batch tail-padded
to ``max_batch`` by repeating the last request (the reference's tail-pad
rule, netbase.py:287-307).  An estimator that holds a frozen program is
called as it is, tail-padded the same way (on a card its loader replays a
graph of its own).  A padded row costs what a real one does: little for a
crop regressor, a whole forward pass for V2V-PoseNet.

A ``parallel.serve.ShardedEstimator`` is called as it is, with every
batch padded to ``max_batch``, which must be a multiple of its
data-parallel size (the JAX server's --dp rule); it replays one CUDA graph
per replica where its replicas capture.

A lone request pays up to ``max_wait_ms`` extra latency; under load the
batch fills before the deadline.

``stats`` counts frames, batches, errors and ``rows``, the rows the device
computed over all batches, padding included (1 - frames / rows is the
padding's share: 0 on the graph path), and sums two times in seconds:
``queue_wait_s``, each request's wait from ``submit`` to the start of its
batch's staging, and ``stage_s``, the batches' staging.  While spans record
(utils/profiling.py) the collector thread records ``server.collect`` and,
for each batch (its number the ``id``), ``server.batch`` (``frames``,
``padded``) around ``server.stage`` (the stack into the pinned or plain
host buffers), ``server.launch`` (the copies to the device and the replay,
or the eager call; ``rows``, the rows the device computes, padding
included), ``server.fetch`` (the joints' copy to the host, which waits for
the device) and ``server.resolve``; and a ``server.request`` per request,
from ``submit`` to its Future resolving (``batch``).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepprior_tpu_torch.realtime.fused import Captured, FusedEstimator
from deepprior_tpu_torch.utils.profiling import collector_held, enabled, record, span, timed


@dataclass
class _Request:
    depth: np.ndarray  # (H, W) raw mm
    com: np.ndarray  # (3,) image coords
    cube: Optional[np.ndarray]  # (3,) mm or None -> estimator default
    mirror: bool
    future: Future
    # time.perf_counter_ns() as submit makes it
    submitted_ns: int = field(default_factory=time.perf_counter_ns)
    number: int = 0  # the server's request number


class _Staging(NamedTuple):
    """One frame shape's staging: pinned host buffers for a (max_batch, H,
    W) batch and its CoMs, and on the graph path the CUDA graphs by row
    count, ``graphs[n - 1]`` computing n rows over the leading n rows of
    ``full``'s static buffers and outputs, in ``full``'s memory pool
    (``FusedEstimator._capture``): together they hold about the memory of
    one graph at max_batch rows."""

    full: Optional[Captured]  # the graph at max_batch rows (graphs[-1]), or None
    depth: torch.Tensor
    com: torch.Tensor
    graphs: Tuple[Captured, ...]


class MicroBatchServer:
    """Groups concurrent single-frame requests into one device batch.

    ``submit`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to the (J, 3) joints in mm.  All requests of a batch run as
    one pipeline call: a replay at the batch's own row count, or an eager
    or fixed-program call at ``max_batch`` rows; per-request
    ``cube``/``mirror`` ride the pipeline's per-sample config.
    """

    def __init__(
        self,
        est,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        frame_shape: Optional[tuple] = None,
        graph: bool = True,
    ):
        """``est`` is a FusedEstimator, or an estimator that holds a frozen
        program (``realtime.export.ArtifactEstimator``, the JAX server's
        ``variables=None`` mode) or spans several devices
        (``parallel.serve.ShardedEstimator``): it is called ``est(depth,
        com)``, its configuration is fixed, so per-request cube/mirror raise
        ValueError, and ``max_batch`` must be its compiled batch, or a
        multiple of its data-parallel size ``dp``.

        ``frame_shape`` pins the accepted (H, W); by default it is the
        estimator's camera resolution, so a stray request with another
        shape fails its own caller with a ValueError instead of locking
        the server to it.

        ``graph``: replay CUDA graphs of the pipeline where the estimator
        ``captures`` (True), or run it eagerly (False).  The graphs, one
        for each row count, are captured here when the frame shape is
        known, else at the first batch."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_batch % getattr(est, "dp", 1):
            raise ValueError(f"max_batch {max_batch} is not a multiple of the "
                             f"estimator's data-parallel size {est.dp}")
        self.est = est
        self._fixed = not isinstance(est, FusedEstimator)
        # an estimator over CUDA replicas (ShardedEstimator) takes each batch
        # from pinned host memory, which its replicas copy from asynchronously
        self._pin_fixed = self._fixed and any(
            getattr(d, "type", None) == "cuda" for d in getattr(est, "devices", ()))
        self.graph = bool(graph) and not self._fixed and est.captures
        # the card the worker thread launches on, whichever thread captured
        self._cuda_index = None
        if not self._fixed and est.device.type == "cuda":
            self._cuda_index = (torch.cuda.current_device() if est.device.index is None
                                else est.device.index)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._running = True
        if frame_shape is None:
            cam = getattr(est, "camera", None)
            if cam is not None:
                frame_shape = (int(cam.height), int(cam.width))
        # pinned (H, W); None only when the estimator carries no camera,
        # in which case the shape commits on the first SUCCESSFUL batch
        self._frame_shape: Optional[tuple] = (
            tuple(frame_shape) if frame_shape is not None else None
        )
        self._tentative_shape: Optional[tuple] = None
        # the pinned staging and the graphs, one _Staging per frame shape
        self._staged: dict = {}
        if self.graph and self._frame_shape is not None:
            self._stage(self._frame_shape)
        # orders submit's {check _running, enqueue} against close's
        # {clear _running, enqueue sentinel}, so no Future is left
        # unresolved by a submit racing close
        self._submit_lock = threading.Lock()
        self._requests = itertools.count()
        self._batches = itertools.count()
        self._batch = None  # the number of the batch the worker runs
        # realized occupancy = frames / (batches * max_batch)
        self.stats = {"frames": 0, "batches": 0, "errors": 0, "rows": 0,
                      "queue_wait_s": 0.0, "stage_s": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(
        self,
        depth: np.ndarray,
        com: np.ndarray,
        cube: Optional[np.ndarray] = None,
        mirror: bool = False,
    ) -> Future:
        """Enqueue one frame; returns a Future of the (J, 3) mm joints."""
        if not self._running:
            raise RuntimeError("server is closed")
        if self._fixed and (cube is not None or mirror):
            raise ValueError(
                "per-request cube/mirror need a FusedEstimator (this server's "
                "estimator holds a fixed-config program)"
            )
        d = np.asarray(depth, np.float32)
        c = np.asarray(com, np.float32)
        if d.ndim != 2 or c.shape != (3,):
            raise ValueError(
                f"bad request shapes: depth {d.shape} (want (H, W)), "
                f"com {c.shape} (want (3,))"
            )
        fut: Future = Future()
        req = _Request(
            depth=d,
            com=c,
            cube=None if cube is None else np.asarray(cube, np.float32),
            mirror=bool(mirror),
            future=fut,
        )
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("server is closed")
            # one frame resolution per batch: rejecting a stray one here
            # fails only that caller
            pin = self._frame_shape or self._tentative_shape
            if pin is None:
                self._tentative_shape = d.shape
            elif d.shape != pin:
                raise ValueError(
                    f"frame shape {d.shape} does not match this server's "
                    f"{pin}"
                )
            req.number = next(self._requests)
            self._q.put(req)
        return fut

    def close(self):
        """Drain outstanding requests, then stop the collector thread."""
        with self._submit_lock:
            if not self._running:
                return
            self._running = False
            self._q.put(None)  # wake the collector
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _collect(self):
        """Block for the first request, then gather until the batch is
        full or ``max_wait_ms`` passed.  Returns (requests, stop)."""
        items = []
        stop = False
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return items, stop
        if first is None:
            return items, True
        items.append(first)
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                stop = True
                break
            items.append(nxt)
        return items, stop

    def _loop(self):
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            with span("server.collect"):
                items, stop = self._collect()
            # one batch per frame shape: in the cameraless fallback a
            # failed batch clears the tentative pin while same-shape
            # requests may still be queued
            groups: dict = {}
            for r in items:
                groups.setdefault(r.depth.shape, []).append(r)
            for shape, grp in groups.items():
                try:
                    self._run_batch(grp)
                    if self._frame_shape is None:
                        # cameraless fallback: the shape is proven good
                        with self._submit_lock:
                            self._frame_shape = shape
                            self._tentative_shape = None
                except Exception as e:  # resolve callers, keep serving
                    self.stats["errors"] += 1
                    if self._frame_shape is None:
                        with self._submit_lock:
                            self._tentative_shape = None
                    for r in grp:
                        if not r.future.done():
                            r.future.set_exception(e)
            if stop:
                # drain anything enqueued after the close() sentinel
                while True:
                    try:
                        r = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if r is not None:
                        r.future.set_exception(
                            RuntimeError("server closed")
                        )

    def _stage(self, shape) -> _Staging:
        """The pinned host buffers for a (max_batch, *shape) batch and its
        CoMs and, on the graph path, the graphs at 1 to max_batch rows (one
        collection of Python's garbage for them all), made on first use."""
        if shape not in self._staged:
            b = self.max_batch
            graphs = ()
            if self.graph:
                with collector_held():
                    full = self.est._capture(b, shape)
                    # largest first: each capture's working memory fits in
                    # the pool's blocks that the one before it freed
                    graphs = tuple(reversed([self.est._capture(n, shape, over=full)
                                             for n in range(b - 1, 0, -1)])) + (full,)
            self._staged[shape] = _Staging(
                graphs[-1] if graphs else None,
                torch.empty((b, *shape), dtype=torch.float32).pin_memory(),
                torch.empty((b, 3), dtype=torch.float32).pin_memory(), graphs)
        return self._staged[shape]

    def _run_batch(self, items):
        n = len(items)
        rows = n if self.graph else self.max_batch
        batch = self._batch = next(self._batches)
        with span("server.batch", id=batch, frames=n, padded=rows - n), \
                torch.inference_mode(self.graph):
            staged = (self._stage(items[0].depth.shape)
                      if self.graph or self._pin_fixed else None)
            with timed("server.stage", id=batch) as staging:
                inputs = self._stack(items, rows, staged)
            self.stats["stage_s"] += staging.seconds
            self.stats["queue_wait_s"] += 1e-9 * sum(staging.start_ns - r.submitted_ns
                                                     for r in items)
            with span("server.launch", id=batch, rows=rows):
                joints = self._launch(inputs, staged)
            with span("server.fetch", id=batch):
                # one copy to the host resolves the whole batch
                joints = torch.as_tensor(joints).cpu().numpy()
            with span("server.resolve", id=batch):
                self._resolve(items, joints)

    def _stack(self, items, rows, staged):
        """The batch on the host as ``rows`` rows: its frames and CoMs
        stacked (into the leading rows of the pinned buffers where the
        batch goes to the device from them), tail-padded by repeating the
        last request up to ``rows`` (netbase.py:290-296; padded rows are
        computed and discarded), and per-request cube and mirror, or None
        when every request takes the estimator's."""
        pad = rows - len(items)
        depths = [r.depth for r in items] + [items[-1].depth] * pad
        coms = [r.com for r in items] + [items[-1].com] * pad
        if staged is None:
            if self._fixed:
                return np.stack(depths), np.stack(coms), None, None
            depth_in, com_in = torch.from_numpy(np.stack(depths)), torch.from_numpy(np.stack(coms))
        else:
            # the previous batch's copies from the pinned buffers have
            # landed: its joints' copy to the host waited for them
            depth_in, com_in = staged.depth[:rows], staged.com[:rows]
            np.stack(depths, out=depth_in.numpy())
            np.stack(coms, out=com_in.numpy())
        if self._fixed or not any(r.cube is not None or r.mirror for r in items):
            return depth_in, com_in, None, None
        default_cube = self.est.cube.cpu().numpy()
        cube = torch.from_numpy(np.stack(
            [default_cube if r.cube is None else r.cube for r in items]
            + [default_cube] * pad))
        mirror = torch.from_numpy(
            np.asarray([r.mirror for r in items] + [False] * pad, bool))
        return depth_in, com_in, cube, mirror

    def _launch(self, inputs, staged):
        """The pipeline on a stacked batch: the copies to the device and the
        replay of the graph at the batch's row count, or the eager call;
        returns the joints, on the device."""
        depth_in, com_in, cube, mirror = inputs
        if self._fixed:
            return self.est(depth_in, com_in)[0]
        if self.graph:
            n = depth_in.shape[0]
            cap = staged.graphs[n - 1]
            cap.depth.copy_(depth_in, non_blocking=True)
            cap.com.copy_(com_in, non_blocking=True)
            if cube is not None:
                cap.cube.copy_(cube)
                cap.mirror.copy_(mirror)
            else:
                cap.cube.copy_(self.est.cube.expand(n, 3))
                cap.mirror.zero_()
            cap.graph.replay()
            return cap.outputs[0]
        dev = self.est.device
        if cube is not None:
            return self.est(depth_in.to(dev), com_in.to(dev), cube=cube.to(dev),
                            mirror=mirror.to(dev))[0]
        return self.est(depth_in.to(dev), com_in.to(dev))[0]

    def _resolve(self, items, joints_np):
        """Resolve each request's Future from its row of the batch's joints
        (``len(joints_np)`` rows computed, padding included)."""
        self.stats["frames"] += len(items)
        self.stats["batches"] += 1
        self.stats["rows"] += len(joints_np)
        traced = enabled()
        for i, r in enumerate(items):
            r.future.set_result(joints_np[i])
            if traced:
                record("server.request", r.submitted_ns, time.perf_counter_ns(), id=r.number,
                       batch=self._batch)

    # ------------------------------------------------------------------
    def occupancy(self) -> float:
        """Realized mean batch fill fraction (1.0 = every batch full)."""
        b = self.stats["batches"]
        if not b:
            return 0.0
        return self.stats["frames"] / (b * self.max_batch)

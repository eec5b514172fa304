"""Profiling and timing hooks (counterpart of deepprior_tpu/utils/profiling.py).

The reference exposes print-based timing only: ms/frame in computeOutput
(netbase.py:308-310), per-stage ms in the realtime pipeline, epochs/sec in
the trainer.  ``StageTimer`` keeps that surface.  The device timers follow
the card's own clock: CUDA events around the work, and a CUDA graph for
the device floor of a carried loop.  Passing CPU tensors is the caller
asking for the CPU; only then do the timers read the host clock.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import threading
import time
from typing import Callable, Dict

import torch


class StageTimer:
    """Named stage timings with running averages (the fps/ms surface)."""

    def __init__(self, window: int = 100):
        self.window = window
        self._hist: Dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            h = self._hist.setdefault(name, [])
            h.append(time.perf_counter() - t0)
            del h[: -self.window]

    def ms(self, name: str) -> float:
        h = self._hist.get(name, [])
        return 1000.0 * sum(h) / len(h) if h else 0.0

    def fps(self, name: str) -> float:
        ms = self.ms(name)
        return 1000.0 / ms if ms > 0 else 0.0

    def report(self) -> str:
        return " ".join(f"{k}={self.ms(k):.2f}ms" for k in sorted(self._hist))


@contextlib.contextmanager
def device_trace(log_dir: str = "torch-trace"):
    """torch.profiler over a region (the CPU, and the card when there is
    one); on exit writes a chrome trace into ``log_dir`` (view it in
    chrome://tracing or Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the region by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    stamp = time.strftime("%Y%m%d-%H%M%S")
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{stamp}-{os.getpid()}.json"))


_GC_HELD = {"captures": 0, "was_enabled": True}
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def graph_capture(graph):
    """``torch.cuda.graph(graph)`` with Python's cyclic garbage
    collector run first and held off until the capture ends.  A CUDA graph
    left in a reference cycle (an estimator and its replay closures) is
    destroyed whenever the collector runs, and destroying one while another
    is being captured invalidates that capture
    (cudaErrorStreamCaptureInvalidated); torch no longer collects before a
    capture by default.  Captures in several threads share one hold: the
    collector comes back when the last of them ends."""
    with _GC_LOCK:
        if _GC_HELD["captures"] == 0:
            gc.collect()
            _GC_HELD["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC_HELD["captures"] += 1
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        with _GC_LOCK:
            _GC_HELD["captures"] -= 1
            if _GC_HELD["captures"] == 0 and _GC_HELD["was_enabled"]:
                gc.enable()


def _first_tensor(tree):
    """The first tensor in a (nested) tuple/list/dict, or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _device_of(*trees) -> torch.device:
    """The device of the first tensor in ``trees``; raises if none holds one."""
    for tree in trees:
        t = _first_tensor(tree)
        if t is not None:
            return t.device
    raise TypeError("no tensor among the outputs or inputs: nothing names a device")


def _drain(out):
    """Completion barrier: ``torch.cuda.synchronize`` on the device that
    ``out``'s tensors live on; nothing for CPU tensors, which are done when
    the call returns."""
    dev = _device_of(out)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cuda_events_ms(run: Callable[[], None], device) -> float:
    """ms of one ``run()`` on the card, from CUDA events on the current
    stream of ``device``."""
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def device_loop_latency(
    step: Callable, carry0, iters: int = 100, args=()
) -> float:
    """Pure device ms/iteration of ``step`` (carry, *args) -> carry.

    On the card the ``iters`` carried steps are captured into ONE CUDA
    graph (``torch.cuda.CUDAGraph``) and its replay is timed with CUDA
    events: no per-iteration dispatch, so the number is the device's
    serving floor, the counterpart of the JAX package's single
    ``fori_loop``.  ``step`` must run only work that a CUDA graph can
    capture (no host sync, no host-side decision on device values) and
    thread its carry, as the JAX helper asks.  The loop-invariant tensors
    go through ``args``; the graph reads them at their current addresses
    at every replay.

    With CPU tensors (the caller asking for the CPU) the steps run
    eagerly under the host clock."""
    dev = _device_of(carry0, args)
    if dev.type != "cuda":
        c = step(carry0, *args)  # warm-up
        t0 = time.perf_counter()
        c = carry0
        for _ in range(iters):
            c = step(c, *args)
        return 1000.0 * (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        # warm up on a side stream, as capture requires (lazy init, cuDNN
        # and cuBLAS handles and workspaces)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                step(carry0, *args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph):
            c = carry0
            for _ in range(iters):
                c = step(c, *args)
        graph.replay()  # first replay uploads the graph
        ms = _cuda_events_ms(graph.replay, dev)
        del graph
        return ms / iters


def kernel_ms(fn: Callable, args, iters: int = 50) -> float:
    """ms of one ``fn(*args)`` without its dispatch: ``iters`` calls
    captured into one CUDA graph and replayed (``device_loop_latency``
    with a dummy carry), so a kernel shorter than its Python wrapper's
    dispatch is timed by the card, not by the host.  ``fn`` must be
    capturable, as for ``device_loop_latency``.  With CPU tensors the
    host clock brackets eager calls."""
    carry = torch.zeros(1, device=_device_of(args))
    return device_loop_latency(lambda c, *a: (fn(*a), c)[1], carry, iters, args)


def time_batched_inference(fn: Callable, args, iters: int = 20) -> float:
    """ms/batch of ``fn(*args)`` including its dispatch
    (computeOutput(timeit=True) analog, netbase.py:308-310).

    After one warm-up call, ``iters`` calls are queued back to back; on
    the card CUDA events on the current stream bracket them, so the time
    is the host's dispatch or the device's work, whichever is longer.
    With CPU outputs (the caller asking for the CPU) the host clock
    brackets them."""
    out = fn(*args)
    dev = _device_of(out, args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return 1000.0 * (time.perf_counter() - t0) / iters

    def run():
        for _ in range(iters):
            fn(*args)

    _drain(out)
    return _cuda_events_ms(run, dev) / iters


def card_label(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (one line for
    ``device``, default the current one).  Every time taken on the card
    is reported beside it: a card set below its maximum power runs slower
    under load.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_label: no CUDA device")
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    proc = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def require_cuda(what: str) -> torch.device:
    """The current CUDA device, or RuntimeError naming ``what``: the
    measuring scripts time the card and have no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} measures the CUDA card and torch.cuda.is_available() is "
            "False; it has no CPU fallback"
        )
    return torch.device("cuda", torch.cuda.current_device())


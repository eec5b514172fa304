"""Profiling and timing hooks: the port's span recorder, and device timers
(the counterparts of deepprior_tpu/utils/profiling.py's).

Spans.  ``span(name, id=None, **attrs)`` records one span of the host's
time at a layer boundary (the server, the realtime pipeline and its
detection, the train step): its name, start and end on
``time.perf_counter_ns()``, thread, parent (the innermost span open in the
same thread), ``id`` (the request, batch, frame or step number, shared by
the spans of one unit of work) and ``attrs``.  ``annotate(**counts)`` adds
counts to the innermost open span of the calling thread, recorded with it.
Spans are recorded while a ``torch.profiler`` session records in this
process, or inside ``recording()``; otherwise ``span`` returns one shared
no-op object and reads no clock.  ``timed`` is a span that always reads
the clock, for timings the program keeps whether or not it records.  The
newest ``MAX_SPANS`` spans stay in memory (``spans()``, ``clear()``);
``to_wall_ns`` puts a span's times on ``time.time_ns()``, the clock of the
profiler's events.  No span opens inside a CUDA graph's capture.

The device timers follow the card's own clock: CUDA events around the
work, and a CUDA graph for the device floor of a carried loop.  Passing
CPU tensors is the caller asking for the CPU; only then do the timers read
the host clock.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import subprocess
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 200_000  # the newest spans kept in memory
_OFFSET_REFRESH_NS = 1_000_000_000  # how old the wall-clock offset may grow while recording


class Span(NamedTuple):
    """One recorded span; times on ``time.perf_counter_ns()``."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the thread that closed it
    seq: int  # its number among the process's spans
    parent: Optional[int]  # the seq of the span it opened in, or None
    id: object  # the request, batch, frame or step number, or None
    attrs: dict

    @property
    def seconds(self) -> float:
        return 1e-9 * (self.end_ns - self.start_ns)


class _Recorder:
    """The process's spans and switches."""

    def __init__(self):
        self.spans = collections.deque(maxlen=MAX_SPANS)
        self.seq = itertools.count()
        self.local = threading.local()  # .stack: the thread's open spans
        self.lock = threading.Lock()
        self.depth = 0  # recording() blocks open
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.offset_at = None  # perf_counter_ns when offset_ns was sampled

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def sample_offset(self, now_ns: int, force: bool = False):
        """Sample ``time.time_ns() - time.perf_counter_ns()`` when recording
        starts, and again once it is a second old."""
        if force or self.offset_at is None or now_ns - self.offset_at > _OFFSET_REFRESH_NS:
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
            self.offset_at = now_ns


_REC = _Recorder()


def enabled() -> bool:
    """True while spans are recorded: inside ``recording()``, or while a
    ``torch.profiler`` session records in this process (the flag torch sets
    at the profiler's start and clears at its stop)."""
    return bool(_REC.depth or _autograd_profiler._is_profiler_enabled)


class _NoSpan:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _OpenSpan:
    """A span being timed; recorded as it closes if it opened while on."""

    __slots__ = ("name", "id", "attrs", "start_ns", "end_ns", "seq", "parent", "live")

    def __init__(self, name, id, attrs):
        self.name, self.id, self.attrs = name, id, attrs
        self.end_ns = None

    def __enter__(self):
        self.live = enabled()
        self.start_ns = now = time.perf_counter_ns()
        if self.live:
            stack = _REC.stack()
            self.parent = stack[-1].seq if stack else None
            self.seq = next(_REC.seq)
            stack.append(self)
            _REC.sample_offset(now)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.live:
            _REC.stack().pop()
            _REC.spans.append(Span(self.name, self.start_ns, self.end_ns, threading.get_ident(),
                                   self.seq, self.parent, self.id, self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return 1e-9 * (self.end_ns - self.start_ns)


def span(name: str, id=None, **attrs):
    """A context manager that records the span ``name`` while ``enabled()``;
    otherwise the shared no-op object, which reads no clock.  (The test of
    ``enabled()`` is inlined: this is the call the hot paths make.)"""
    if not (_REC.depth or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    return _OpenSpan(name, id, attrs)


def timed(name: str, id=None, **attrs) -> _OpenSpan:
    """``span`` that always reads the clock: after the block, ``start_ns``,
    ``end_ns`` and ``seconds`` hold its times, recorded as the span ``name``
    while ``enabled()``."""
    return _OpenSpan(name, id, attrs)


def annotate(**counts):
    """Add ``counts`` to the innermost open span of the calling thread
    (recorded with it as it closes); nothing while nothing records."""
    if not enabled():
        return
    stack = _REC.stack()
    if stack:
        attrs = stack[-1].attrs
        for k, v in counts.items():
            attrs[k] = attrs.get(k, 0) + v


def record(name: str, start_ns: int, end_ns: int, id=None, **attrs):
    """Record a span whose times the caller read on ``time.perf_counter_ns()``
    (one that began in another thread: it has no parent), while
    ``enabled()``."""
    if not enabled():
        return
    _REC.sample_offset(end_ns)
    _REC.spans.append(Span(name, start_ns, end_ns, threading.get_ident(), next(_REC.seq),
                           None, id, attrs))


@contextlib.contextmanager
def recording():
    """Record spans inside the block, from every thread of the process."""
    with _REC.lock:
        _REC.depth += 1
    _REC.sample_offset(time.perf_counter_ns(), force=True)
    try:
        yield
    finally:
        with _REC.lock:
            _REC.depth -= 1


def spans() -> list:
    """A snapshot of the recorded spans, oldest first by their end."""
    return list(_REC.spans)


def clear():
    """Forget every recorded span."""
    _REC.spans.clear()


def to_wall_ns(perf_ns: int) -> int:
    """``time.perf_counter_ns()`` ``perf_ns`` on ``time.time_ns()``, the clock
    of ``torch.profiler``'s events."""
    return perf_ns + _REC.offset_ns


_GC_HELD = {"holds": 0, "was_enabled": True}
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def collector_held():
    """Python's cyclic garbage collector run once and held off until the
    block ends (``graph_capture``'s hold, for a block of several captures:
    one collection instead of one a capture).  Nested holds and holds in
    several threads share one: the collector runs at the first and comes
    back when the last ends, unless the caller had turned it off."""
    with _GC_LOCK:
        if _GC_HELD["holds"] == 0:
            gc.collect()
            _GC_HELD["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC_HELD["holds"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HELD["holds"] -= 1
            if _GC_HELD["holds"] == 0 and _GC_HELD["was_enabled"]:
                gc.enable()


@contextlib.contextmanager
def graph_capture(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's cyclic garbage
    collector run first and held off until the capture ends
    (``collector_held``).  A CUDA graph left in a reference cycle (an
    estimator and its replay closures) is destroyed whenever the collector
    runs, and destroying one while another is being captured invalidates
    that capture (cudaErrorStreamCaptureInvalidated); torch no longer
    collects before a capture by default.  Captures in several threads
    share one hold: the collector comes back when the last of them ends."""
    with collector_held(), torch.cuda.graph(graph, pool=pool):
        yield


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


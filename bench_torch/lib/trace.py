"""The traced run's instruments: spans the benchmark records around its calls
into the program, and ``torch.profiler`` over the first seconds of the
measured window, reduced to what the per-layer readers and ``breakdown``
need.

Spans are recorded only in a traced run, on the host clock and on the
wall clock the profiler's events carry, from any thread, so the trace can
say what the host was doing in each idle gap of the device.  On a card the
profiler records the device's activity and the CUDA runtime's calls but
no host operators: those cost a traced ResNet-47 step two thirds of its
rate.  Host-clock readings of a traced run are taken after the profiler
stops (``stopped``).
"""

from __future__ import annotations

import contextlib
import heapq
import time
from collections import defaultdict

import torch


class Tracer:
    """Spans and the profiler of one run.  ``enabled`` False makes every
    method a no-op, so the untraced run measures the program alone."""

    def __init__(self, enabled: bool, profile_seconds: float = 3.0):
        self.enabled = enabled
        self.profile_seconds = float(profile_seconds)
        self.spans = defaultdict(list)  # name -> [(t0, t1)] on perf_counter
        self.wall_spans = []  # (t0 ns, t1 ns, name) on the profiler's clock
        self._prof = None
        self._t0 = None
        self.window = None   # (start ns, stop ns) of the profiled window
        self.perf_window = None  # the same on perf_counter
        self.stopped = None  # perf_counter when the profiler stopped
        self.on_stop = []    # callables run as it stops
        self.events = None

    @staticmethod
    def _profiler(device):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                   else ProfilerActivity.CPU])

    def warm(self, device):
        """Initialize the profiler's device tracing once, in set-up."""
        if not self.enabled:
            return
        with self._profiler(device):
            (torch.zeros(8, device=device) + 1).sum().item()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.perf_counter()))
            if self._prof is not None:
                self.wall_spans.append((w0, time.time_ns(), name))

    def start(self, device):
        """Start the profiler at the window's start (traced runs only)."""
        if not self.enabled:
            return
        self._prof = self._profiler(device)
        self._prof.start()
        self._t0 = time.perf_counter()
        self.window = [time.time_ns(), None]
        self.perf_window = [self._t0, None]

    def poll(self):
        """Stop the profiler once it has run ``profile_seconds``."""
        if self._prof is not None and time.perf_counter() - self._t0 >= self.profile_seconds:
            self.stop()

    def stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window[1] = time.time_ns()
        self.perf_window[1] = time.perf_counter()
        prof.stop()
        self.stopped = time.perf_counter()
        for fn in self.on_stop:
            fn()
        self.events = prof.profiler.kineto_results.events()

    def after_stop(self, times, end):
        """The entries of ``times`` (perf_counter starts) after the profiler
        stopped, and the seconds from then to ``end``: the untraced rest of
        a traced window, or all of it when the profiler never ran."""
        if self.stopped is None or self.stopped >= end:
            return list(times), None
        return [t for t in times if t >= self.stopped], end - self.stopped


def reduce_trace(events, window, spans=()) -> dict:
    """Device time by operation name, the device's busy seconds (the union of
    its operations' intervals inside ``window``), and its idle gaps summed
    by what the host was doing: the innermost of the benchmark's ``spans``
    and the innermost host call (a CUDA runtime call on a card) covering
    each gap's midpoint."""
    lo, hi = window
    dev = []
    host = [(a, b, "bench:" + n) for a, b, n in spans]
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            # kernels, copies and memsets; not the spans mirrored onto the
            # device's timeline
            if not name.startswith("bench:") and not _is_annotation(e):
                dev.append((start, end, name))
        elif end > start:
            host.append((start, end, name))
    ops = defaultdict(lambda: [0, 0])
    for start, end, name in dev:
        ops[name][0] += 1
        ops[name][1] += end - start
    intervals = sorted((max(s, lo), min(e, hi)) for s, e, _ in dev if min(e, hi) > max(s, lo))
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    return {
        "ops": {k: (v[0], v[1] / 1e9) for k, v in ops.items()},
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "idle_by_host": _label_gaps(gaps, host),
        # the trace's clock against the window's: the first host event's
        # offset from the window's start, a few ms when they agree
        "first_event_offset_s": (min(h[0] for h in host) - lo) / 1e9 if host else None,
    }


def _is_annotation(event) -> bool:
    is_user = getattr(event, "is_user_annotation", None)
    return bool(is_user()) if is_user is not None else False


def _label_gaps(gaps, host) -> dict:
    """Seconds of idle device time by 'span | call', sweeping the gaps'
    midpoints over the host intervals in order of start."""
    host.sort()
    out = defaultdict(float)
    active = {}
    expiry = []
    j = 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) // 2
        while j < len(host) and host[j][0] <= mid:
            active[j] = host[j]
            heapq.heappush(expiry, (host[j][1], j))
            j += 1
        while expiry and expiry[0][0] < mid:
            active.pop(heapq.heappop(expiry)[1], None)
        spans = [h for h in active.values() if h[2].startswith("bench:")]
        calls = [h for h in active.values() if not h[2].startswith("bench:")]
        span = min(spans, key=lambda h: h[1] - h[0])[2][6:] if spans else "-"
        call = min(calls, key=lambda h: h[1] - h[0])[2] if calls else "-"
        out[f"{span} | {call}"] += (e - s) / 1e9
    return dict(out)


def top(d: dict, n: int = 10, width: int = 160):
    """The ``n`` largest entries of name -> seconds as [[name, seconds]]."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

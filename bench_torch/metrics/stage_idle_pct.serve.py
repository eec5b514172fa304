"""The share of the profiled window in which the card is idle while the
server's thread is in its ``server.stage`` span: the union of the trace's
device operations inside the window, and the time of each ``server.stage``
span (put on the profiler's clock) that no operation covers."""

from bench_torch.metrics import _program_spans


def _busy(events, lo, hi):
    """The device's operations (kernels, copies, memsets) clipped to
    [lo, hi), merged into sorted disjoint intervals."""
    ivs = []
    for e in events:
        annotation = getattr(e, "is_user_annotation", None)
        if not str(e.device_type()).endswith("CUDA") or e.name().startswith("bench:") or (
                annotation is not None and annotation()):
            continue
        s, t = max(e.start_ns(), lo), min(e.start_ns() + e.duration_ns(), hi)
        if t > s:
            ivs.append((s, t))
    merged = []
    for s, t in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def read(rec):
    events = getattr(rec.tracer, "events", None)
    window = getattr(rec.tracer, "window", None)
    stage = _program_spans.in_window(rec, "server.stage")
    if events is None or not window or window[1] is None or not stage:
        return None
    lo, hi = window
    if hi <= lo:
        return None
    busy = _busy(events, lo, hi)
    idle = 0
    for s, t, _ in _program_spans.on_wall_clock(stage):
        s, t = max(s, lo), min(t, hi)
        if t > s:
            idle += (t - s) - sum(max(0, min(t, b) - max(s, a)) for a, b in busy
                                  if a < t and b > s)
    return 100.0 * idle / (hi - lo)

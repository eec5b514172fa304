"""Device time of the operations the program launched inside its spans
``name``: the host calls of the trace (on a card, the CUDA API's calls)
that began inside such a span, matched by their correlation id to the
kernels, copies and memsets they launched.  Where
the launch queue is full, a span's host time reads the waits for queue
slots while earlier work runs, not its own work; this reads the work.  A
trace with no device operation (a CPU run), or a program that recorded no
such span, gives none."""

import bisect

from bench_torch.metrics import _program_spans


def _is_device_op(e) -> bool:
    """A kernel, copy or memset; not a span mirrored onto the device's
    timeline."""
    annotation = getattr(e, "is_user_annotation", None)
    return (str(e.device_type()).endswith("CUDA") and not e.name().startswith("bench:")
            and not (annotation is not None and annotation()))


def mean_ms(rec, name: str):
    """Device ms of the operations launched inside each span ``name`` begun
    in the profiled window, over those spans, or None."""
    events = getattr(rec.tracer, "events", None)
    spans = _program_spans.in_window(rec, name)
    if not events or not spans:
        return None
    wall = sorted((s, t) for s, t, _ in _program_spans.on_wall_clock(spans))
    starts = [s for s, _ in wall]
    launched, device = set(), []
    for e in events:
        if _is_device_op(e):
            device.append(e)
            continue
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if i >= 0 and e.start_ns() < wall[i][1] and e.correlation_id() > 0:
            launched.add(e.correlation_id())
    ns = sum(e.duration_ns() for e in device if e.correlation_id() in launched)
    return 1e-6 * ns / len(spans) if ns else None

"""Device time a train step: every kernel, copy and memset of the traced
window over the benchmark's ``step`` spans that began in it."""


def read(rec):
    ops = rec.trace.get("ops") if rec.trace else None
    win = getattr(rec.tracer, "perf_window", None)
    spans = getattr(rec.tracer, "spans", {}).get("step", [])
    if not ops or not win or win[1] is None:
        return None
    steps = sum(1 for t0, _ in spans if win[0] <= t0 < win[1])
    if not steps:
        return None
    return 1e3 * sum(s for _, s in ops.values()) / steps

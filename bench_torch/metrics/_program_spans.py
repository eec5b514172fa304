"""The program's own spans (``deepprior_tpu_torch.utils.profiling``) for the
per-layer readers: those that began in a traced run's profiled window, where
the program records them.  A program without the recorder, or a run that
recorded none, gives none."""


def _recorder():
    try:
        from deepprior_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def in_window(rec, name: str) -> list:
    """The program's spans ``name`` that began inside ``rec.tracer.perf_window``."""
    win = getattr(rec.tracer, "perf_window", None)
    profiling = _recorder()
    if not win or win[1] is None or profiling is None:
        return []
    lo, hi = win[0] * 1e9, win[1] * 1e9
    return [s for s in profiling.spans() if s.name == name and lo <= s.start_ns < hi]


def on_wall_clock(spans) -> list:
    """(start ns, end ns, name) of each span on the clock of the profiler's
    events, as ``bench_torch.lib.trace.reduce_trace`` takes spans."""
    wall = _recorder().to_wall_ns
    return [(wall(s.start_ns), wall(s.end_ns), s.name) for s in spans]


def mean_ms(rec, name: str):
    """Mean duration in ms of the spans ``name`` in the window, or None."""
    got = in_window(rec, name)
    return 1e-6 * sum(s.end_ns - s.start_ns for s in got) / len(got) if got else None

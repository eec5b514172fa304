"""95th percentile of a request's wait in the server's queue, from
``submit`` to the start of its batch's staging: each ``server.request``
span begun in the profiled window (its ``batch`` attr) against that batch's
``server.stage`` span."""

import numpy as np

from bench_torch.metrics import _program_spans


def read(rec):
    stage = {s.id: s.start_ns for s in _program_spans.in_window(rec, "server.stage")}
    waits = [stage[r.attrs["batch"]] - r.start_ns
             for r in _program_spans.in_window(rec, "server.request")
             if r.attrs.get("batch") in stage]
    return 1e-6 * float(np.percentile(waits, 95)) if waits else None

"""Device time of one batch the server launches: the operations launched
inside the program's ``server.launch`` spans in the profiled window (the
copies to the device and the graph's replay, or the eager call), over those
spans.  A replayed graph's kernels carry the correlation id of its
``cudaGraphLaunch``, so they count as launched inside the span."""

from bench_torch.metrics import _span_device


def read(rec):
    return _span_device.mean_ms(rec, "server.launch")

"""Mean time of device detection's slice scan a frame (the frame's upload,
``ops.com.detect`` and its CoM's copy to the host): the program's
``detect.scan`` spans in the profiled window."""

from bench_torch.metrics import _program_spans


def read(rec):
    return _program_spans.mean_ms(rec, "detect.scan")

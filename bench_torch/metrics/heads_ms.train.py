"""Device time a train step of A2J's three anchor heads' forward pass: the
operations launched inside the program's ``a2j.heads`` spans in the
profiled window, over those spans."""

from bench_torch.metrics import _span_device


def read(rec):
    return _span_device.mean_ms(rec, "a2j.heads")

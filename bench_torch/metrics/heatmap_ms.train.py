"""Device time a train step of V2V-PoseNet's heatmap targets: the
operations launched inside the program's ``train.targets`` spans in the
profiled window, over those spans."""

from bench_torch.metrics import _span_device


def read(rec):
    return _span_device.mean_ms(rec, "train.targets")

"""Device time a train step of A2J's softmax vote over the anchors and its
loss: the operations launched inside the program's ``train.anchor`` spans
in the profiled window, over those spans."""

from bench_torch.metrics import _span_device


def read(rec):
    return _span_device.mean_ms(rec, "train.anchor")

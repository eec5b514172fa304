"""Mean host time of a train step's optimizer update: the program's
``train.optimizer`` spans in the profiled window."""

from bench_torch.metrics import _program_spans


def read(rec):
    return _program_spans.mean_ms(rec, "train.optimizer")

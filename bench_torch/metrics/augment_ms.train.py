"""Mean host time of a train step's augmentation and PCA targets: the
program's ``train.augment`` spans in the profiled window."""

from bench_torch.metrics import _program_spans


def read(rec):
    return _program_spans.mean_ms(rec, "train.augment")

"""K1's share of its roofline: the least time a launch could take (the
benchmark's byte model of the batch's crops over the HBM peak, or its
float32 operations over the float32 peak, whichever is longer) over K1's
mean time in the traced window."""

from bench_torch.models.crop_bytes import crop_ops
from bench_torch.models.peaks import roofline_s


def read(rec):
    n, secs = rec.ops("normalized_crop_kernel")
    win = getattr(rec.tracer, "perf_window", None)
    if rec.peak is None or not n or not win:
        return None
    sizes = [b for t, b in rec.values.get("k1_batch_bytes", []) if win[0] <= t <= win[1]]
    if not sizes:
        return None
    mean_bytes = sum(sizes) / len(sizes)
    least = roofline_s(mean_bytes, crop_ops(rec.values["max_batch"]), rec.peak)
    return 100.0 * least / (secs / n)

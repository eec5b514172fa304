"""K5's share of its roofline: the benchmark's byte model of one launch
over the HBM peak (or its float32 operations over the float32 peak,
whichever is longer) over K5's mean time in the traced window."""

from bench_torch.models.peaks import roofline_s
from bench_torch.models.warp_bytes import warp_bytes, warp_ops


def read(rec):
    n, secs = rec.ops("warp_norm_kernel")
    if rec.peak is None or not n:
        return None
    b = rec.values["batch"]
    return 100.0 * roofline_s(warp_bytes(b), warp_ops(b), rec.peak) / (secs / n)

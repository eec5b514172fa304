"""K10's share of its roofline: the operations of the weight gradients K10
takes in a V2V-PoseNet step (``models/v2v_wgrad_flops.py``, counted on the
reference network) over the float32 peak, over the device seconds a step of
the operations whose name holds ``conv3d_wgrad`` in the traced window, the
steps counted as ``step_device_ms.train`` counts them.  The batch is the
generator's; the grid and the joints are those of the program's
``train.voxelize`` spans.  A program without the kernel gives none."""

from bench_torch.metrics import _program_spans
from bench_torch.models.v2v_wgrad_flops import wgrad_flops


def read(rec):
    n, secs = rec.ops("conv3d_wgrad")
    win = getattr(rec.tracer, "perf_window", None)
    if rec.peak is None or not n or not secs or not win or win[1] is None:
        return None
    steps = sum(1 for t0, _ in getattr(rec.tracer, "spans", {}).get("step", [])
                if win[0] <= t0 < win[1])
    voxelize = _program_spans.in_window(rec, "train.voxelize")
    if not steps or not voxelize or "batch" not in rec.values:
        return None
    attrs = voxelize[0].attrs
    ops = wgrad_flops(rec.values["batch"], attrs["grid"], attrs["joints"])
    return 100.0 * (ops / rec.peak.fp32_flops) / (secs / steps)

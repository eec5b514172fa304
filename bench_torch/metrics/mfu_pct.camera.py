"""ScaleNet's and PoseRegNet's model flops a frame times the frames of the
window, over the window's seconds, as a share of the card's float32
peak."""


def read(rec):
    v = rec.values
    if rec.peak is None or not v.get("frames") or not v.get("window_s"):
        return None
    return 100.0 * v["flops_per_frame"] * v["frames"] / v["window_s"] / rec.peak.fp32_flops

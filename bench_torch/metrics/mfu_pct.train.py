"""The train step's model flops (forward and backward, counted once in
set-up) times the steps of the window, over the window's seconds, as a
share of the card's float32 peak."""


def read(rec):
    v = rec.values
    if rec.peak is None or not v.get("steps") or not v.get("window_s"):
        return None
    return 100.0 * v["step_flops"] * v["steps"] / v["window_s"] / rec.peak.fp32_flops

"""The share of the traced window in which no kernel, copy or memset ran
on the card."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0 or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

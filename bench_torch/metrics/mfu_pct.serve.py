"""The model flops of the frames the server computes (max_batch a batch,
padding included) over the wall time of its batch steps (the benchmark's
span around each call), as a share of the card's float32 peak."""


def read(rec):
    spans = rec.values.get("batch_spans") or []
    busy = sum(b - a for a, b in spans)
    if rec.peak is None or not spans or busy <= 0:
        return None
    return 100.0 * rec.values["flops_per_batch"] * len(spans) / busy / rec.peak.fp32_flops

"""Mean host staging time of a batch (the stack of its frames and CoMs into
the pinned buffers): ``MicroBatchServer.stats['stage_s']`` over the batches
run, in the untraced rest of the window."""


def read(rec):
    s = rec.values.get("server")
    if not s or not s.get("batches") or "stage_s" not in s:
        return None
    return 1e3 * s["stage_s"] / s["batches"]

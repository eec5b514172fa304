"""Mean wait of a request in the server's queue, from ``submit`` to the start
of its batch's staging: ``MicroBatchServer.stats['queue_wait_s']`` over the
frames served, in the untraced rest of the window."""


def read(rec):
    s = rec.values.get("server")
    if not s or not s.get("frames") or "queue_wait_s" not in s:
        return None
    return 1e3 * s["queue_wait_s"] / s["frames"]

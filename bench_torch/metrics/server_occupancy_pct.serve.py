"""The server's realized batch fill over the window: frames served /
(batches run x max_batch), from ``MicroBatchServer.stats``."""


def read(rec):
    s = rec.values.get("server")
    if not s or not s["batches"]:
        return None
    return 100.0 * s["frames"] / (s["batches"] * rec.values["max_batch"])

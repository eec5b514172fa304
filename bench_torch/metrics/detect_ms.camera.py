"""Mean detection time a frame, from the pipeline's own host timer
(``RealtimeHandposePipeline.times['detect']``: device detection and the
ScaleNet refinement, ending in a read-back)."""


def read(rec):
    t = rec.values.get("detect_s")
    return 1e3 * sum(t) / len(t) if t else None

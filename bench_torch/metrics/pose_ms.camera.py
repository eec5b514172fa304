"""Mean pose time a frame at B=1, from the pipeline's own host timer
(``RealtimeHandposePipeline.times['pose']``: the estimator, ending in a
read-back)."""


def read(rec):
    t = rec.values.get("pose_s")
    return 1e3 * sum(t) / len(t) if t else None

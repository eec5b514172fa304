"""The share of V2V-PoseNet's input voxels that a point of the hand
occupies in the frames served over the window, padding rows included: 100 x
the change of the estimator's ``stats['voxels_set']`` over that of
``stats['voxels_seen']``, counted on the device in every replay and read
after the window.  A program without the counters gives none."""


def read(rec):
    seen = rec.values.get("voxels_seen")
    if not seen or "voxels_set" not in rec.values:
        return None
    return 100.0 * rec.values["voxels_set"] / seen

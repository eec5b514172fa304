"""The share of V2V-PoseNet's input voxels that a point of the hand
occupies, over the window: 100 x the program's ``Trainer.stats``
``voxels_set`` over ``voxels_seen``, counted on the device each step and
read after the window.  A program without the counters gives none."""


def read(rec):
    seen = rec.values.get("voxels_seen")
    if not seen or "voxels_set" not in rec.values:
        return None
    return 100.0 * rec.values["voxels_set"] / seen

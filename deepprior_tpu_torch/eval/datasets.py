"""Per-dataset evaluation classes: joint names, skeleton edges, fps
(counterpart of deepprior_tpu/eval/datasets.py; reference
src/util/handpose_evaluation.py:684-913).  The numbers are
``HandposeEvaluation``'s; drawing is not ported yet (ROADMAP.md Queue 1
item 21)."""

from __future__ import annotations

from deepprior_tpu_torch.camera import ICVL_CAMERA, MSRA15_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.eval.metrics import HandposeEvaluation


class ICVLHandposeEvaluation(HandposeEvaluation):
    """16 joints (handpose_evaluation.py:684-760)."""

    camera = ICVL_CAMERA
    joint_names = ["C", "T1", "T2", "T3", "I1", "I2", "I3", "M1", "M2", "M3",
                   "R1", "R2", "R3", "P1", "P2", "P3"]
    joint_connections = [
        [0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7], [7, 8],
        [8, 9], [0, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    ]
    fps = 10.0


class NYUHandposeEvaluation(HandposeEvaluation):
    """NYU: 'eval' = the 14-joint subset, 'all' = 36 joints
    (handpose_evaluation.py:763-860)."""

    camera = NYU_CAMERA
    fps = 25.0
    EVAL_JOINT_NAMES = ["P1", "P2", "R1", "R2", "M1", "M2", "I1", "I2", "T1", "T2",
                        "T3", "W1", "W2", "C"]
    EVAL_CONNECTIONS = [
        [13, 1], [1, 0], [13, 3], [3, 2], [13, 5], [5, 4], [13, 7], [7, 6],
        [13, 10], [10, 9], [9, 8], [13, 11], [13, 12],
    ]
    ALL_CONNECTIONS = [
        [33, 5], [5, 4], [4, 3], [3, 2], [2, 1], [1, 0],
        [32, 11], [11, 10], [10, 9], [9, 8], [8, 7], [7, 6],
        [32, 17], [17, 16], [16, 15], [15, 14], [14, 13], [13, 12],
        [32, 23], [23, 22], [22, 21], [21, 20], [20, 19], [19, 18],
        [34, 29], [29, 28], [28, 27], [27, 26], [26, 25], [25, 24],
        [34, 32], [34, 33], [33, 32], [34, 30], [34, 31], [35, 30], [35, 31],
    ]
    # the eval subset at class level, for dispatch by joint count
    joint_names = EVAL_JOINT_NAMES
    joint_connections = EVAL_CONNECTIONS

    def __init__(self, gt, joints, joint_subset: str = "eval", dolegend=True):
        super().__init__(gt, joints, dolegend)
        if joint_subset == "eval":
            self.joint_names = self.EVAL_JOINT_NAMES
            self.joint_connections = self.EVAL_CONNECTIONS
        elif joint_subset == "all":
            self.joint_names = [f"J{i}" for i in range(36)]
            self.joint_connections = self.ALL_CONNECTIONS
        else:
            raise ValueError(f"unknown joint subset {joint_subset!r}")


class NYUAllHandposeEvaluation(NYUHandposeEvaluation):
    """NYU's 36 joints, with the 'all' skeleton at class level."""

    joint_names = [f"J{i}" for i in range(36)]
    joint_connections = NYUHandposeEvaluation.ALL_CONNECTIONS

    def __init__(self, gt, joints, joint_subset: str = "all", dolegend=True):
        super().__init__(gt, joints, joint_subset, dolegend)


class MSRAHandposeEvaluation(HandposeEvaluation):
    """21 joints (handpose_evaluation.py:863-913)."""

    camera = MSRA15_CAMERA
    joint_names = ["C", "T1", "T2", "T3", "T4", "I1", "I2", "I3", "I4", "M1", "M2",
                   "M3", "M4", "R1", "R2", "R3", "R4", "P1", "P2", "P3", "P4"]
    joint_connections = [
        [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
        [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
        [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
    ]
    fps = 20.0


def evaluation_for(num_joints: int):
    """The class for a joint count (realtimehandposepipeline.py:398-405)."""
    return {16: ICVLHandposeEvaluation, 14: NYUHandposeEvaluation,
            36: NYUAllHandposeEvaluation, 21: MSRAHandposeEvaluation}[num_joints]

"""Hand-pose metric suite over (N, J, 3) ground-truth/prediction arrays.

A numpy copy of the numbers of deepprior_tpu/eval/metrics.py (reference
src/util/handpose_evaluation.py:92-228): mean/max/median errors, per-joint
variants, per-frame sequences and frames-within-distance counts, with the
same NaN contract.  The plots are not ported yet (ROADMAP.md Queue 1
item 1, ``eval/plots.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_PLOTS_TODO = (
    "evaluation plots are not ported yet (ROADMAP.md Queue 1 item 1, "
    "eval/plots.py)"
)


class HandposeEvaluation:
    """Metric container over ground truth and predictions in mm."""

    plot_max_dist = 80.0  # mm, threshold-curve x-range

    def __init__(self, gt: np.ndarray, joints: np.ndarray, dolegend=True):
        gt = np.asarray(gt, np.float32)
        joints = np.asarray(joints, np.float32)
        if gt.shape != joints.shape or gt.ndim != 3:
            raise ValueError(
                f"gt {gt.shape} and predictions {joints.shape} must both be (N, J, 3)"
            )
        if gt.shape[0] == 0:
            # reference: "Params must be of non-zero size" (:63-65)
            raise ValueError("evaluation inputs must be non-empty")
        # NaN inputs are allowed (reference is nan-tolerant throughout);
        # NaN propagates into self.dists per joint.
        self.gt = gt
        self.joints = joints
        self.dolegend = dolegend
        self.subfolder = "./eval/"
        # (N, J) per-joint Euclidean distances
        self.dists = np.sqrt(np.sum((gt - joints) ** 2, axis=2))

    # ------------------------------------------------------------------
    def getMeanError(self) -> float:
        """nanmean over frames of (nanmean over joints) error
        (handpose_evaluation.py:92-98)."""
        return float(np.nanmean(np.nanmean(self.dists, axis=1)))

    def getStdError(self) -> float:
        """nanmean over frames of the PER-FRAME nanstd over joints
        (handpose_evaluation.py:99-105) — i.e. how unevenly the error is
        spread across the joints of a typical frame, NOT the frame-to-frame
        spread of the mean error."""
        return float(np.nanmean(np.nanstd(self.dists, axis=1)))

    def getMedianError(self) -> np.ndarray:
        """(J,) PER-JOINT nanmedians over the sequence
        (handpose_evaluation.py:114-121: `scipy.stats.nanmedian(dists)`
        whose default axis is 0).  Returns an array, like the reference;
        summarize with e.g. float(np.mean(...)) if a scalar is needed."""
        return np.nanmedian(self.dists, axis=0)

    def getMaxError(self) -> float:
        return float(np.nanmax(self.dists))

    def getJointMeanError(self, joint: int) -> float:
        return float(np.nanmean(self.dists[:, joint]))

    def getJointStdError(self, joint: int) -> float:
        return float(np.nanstd(self.dists[:, joint]))

    def getJointMaxError(self, joint: int) -> float:
        return float(np.nanmax(self.dists[:, joint]))

    def getErrorPerFrame(self) -> np.ndarray:
        return np.nanmean(self.dists, axis=1)

    def getMaxErrorPerFrame(self) -> np.ndarray:
        return np.nanmax(self.dists, axis=1)

    # ------------------------------------------------------------------
    # per-frame ("over sequence") surface, handpose_evaluation.py:106-228
    # ------------------------------------------------------------------
    def getMeanErrorOverSeq(self) -> np.ndarray:
        """(N,) nanmean-over-joints error per frame
        (handpose_evaluation.py:106-112)."""
        return np.nanmean(self.dists, axis=1)

    def getMaxErrorOverSeq(self) -> np.ndarray:
        """(N,) worst-joint (nanmax) error per frame
        (handpose_evaluation.py:130-136)."""
        return np.nanmax(self.dists, axis=1)

    def getJointErrorOverSeq(self, joint: int) -> np.ndarray:
        """(N,) Euclidean error of one joint per frame
        (handpose_evaluation.py:156-163)."""
        return self.dists[:, joint]

    def getJointDiffOverSeq(self, joint: int) -> np.ndarray:
        """(N, 3) signed gt - prediction offsets of one joint
        (handpose_evaluation.py:165-172)."""
        return self.gt[:, joint, :] - self.joints[:, joint, :]

    @staticmethod
    def cumulativeMovingAverage(data) -> np.ndarray:
        """Running average of a 1D series, (N, 1) like the reference.

        Reproduces the reference quirk (handpose_evaluation.py:183-194)
        exactly: entry 0 is data[0], entry i >= 1 averages data[0:i] —
        EXCLUDING data[i] — so the curve lags one sample.  Vectorized
        (the reference is an O(N^2) Python loop)."""
        data = np.asarray(data, np.float64).reshape(-1)
        out = np.empty((data.shape[0], 1), float)
        out[0, 0] = data[0]
        if data.shape[0] > 1:
            # nanmean semantics: divide by the non-NaN count of the prefix
            counts = np.cumsum(~np.isnan(data), dtype=np.float64)[:-1]
            with np.errstate(invalid="ignore", divide="ignore"):
                out[1:, 0] = np.nancumsum(data)[:-1] / counts
        return out

    def getNumFramesWithinMaxDist(self, dist: float) -> int:
        """Frames whose WORST joint (nanmax) is within `dist` mm
        (handpose_evaluation.py:196-202, the standard success-rate metric)."""
        return int((np.nanmax(self.dists, axis=1) <= dist).sum())

    def getNumFramesWithinMeanDist(self, dist: float) -> int:
        return int((np.nanmean(self.dists, axis=1) <= dist).sum())

    def getNumFramesWithinMedianDist(self, dist: float) -> int:
        """Frames whose MEDIAN joint error is within `dist` mm
        (handpose_evaluation.py:213-219).  Reference quirk kept: PLAIN
        median, so any NaN joint makes the frame's median NaN -> excluded."""
        return int((np.median(self.dists, axis=1) <= dist).sum())

    def getJointNumFramesWithinMaxDist(self, dist: float, joint: int) -> int:
        """Frames where one specific joint is within `dist` mm
        (handpose_evaluation.py:221-228)."""
        return int((self.dists[:, joint] <= dist).sum())

    def getFractionWithinMaxDist(self, dist: float) -> float:
        return self.getNumFramesWithinMaxDist(dist) / self.dists.shape[0]

    def successCurve(self, thresholds: Optional[np.ndarray] = None):
        """(thresholds, fraction of frames with max-joint error <= t)."""
        if thresholds is None:
            thresholds = np.arange(0.0, self.plot_max_dist + 1.0, 1.0)
        worst = np.nanmax(self.dists, axis=1)
        frac = (worst[None, :] <= thresholds[:, None]).mean(axis=1)
        return thresholds, frac

    # ------------------------------------------------------------------
    def plotEvaluation(self, name: str, methodName="Ours", baseline=None):
        raise NotImplementedError(_PLOTS_TODO)

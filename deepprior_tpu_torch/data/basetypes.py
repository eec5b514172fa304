"""Base containers for depth-frame datasets (copies of
deepprior_tpu/data/basetypes.py; reference src/data/basetypes.py:34-37)."""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np


class DepthFrame(NamedTuple):
    """One imported depth frame and its annotations.

    dpt:       cropped depth patch (H, W) float32, mm (0 = invalid/far)
    gtorig:    (J, 3) joints in original image coords (u, v, d)
    gtcrop:    (J, 3) joints in crop coords (transformPoints2D(gtorig, T))
    T:         (3, 3) crop transform M
    gt3Dorig:  (J, 3) joints in metric 3D (mm)
    gt3Dcrop:  (J, 3) CoM-centered metric 3D joints (gt3Dorig - com3D)
    com:       (3,) crop CoM in image coords (u, v, d)
    fileName:  source file
    subSeqName: sub-sequence tag
    side:      'left' / 'right'
    extraData: dataset-specific extras
    """

    dpt: np.ndarray
    gtorig: np.ndarray
    gtcrop: np.ndarray
    T: np.ndarray
    gt3Dorig: np.ndarray
    gt3Dcrop: np.ndarray
    com: np.ndarray
    fileName: str = ""
    subSeqName: str = ""
    side: str = "right"
    extraData: Optional[Dict[str, Any]] = None


class ImageSequence(NamedTuple):
    """A named sequence of frames + its crop config."""

    name: str
    data: List[DepthFrame]
    config: Dict[str, Any]

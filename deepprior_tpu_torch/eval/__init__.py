"""Evaluation: the hand-pose metric suite and the per-dataset classes."""

from deepprior_tpu_torch.eval.datasets import (
    ICVLHandposeEvaluation,
    MSRAHandposeEvaluation,
    NYUAllHandposeEvaluation,
    NYUHandposeEvaluation,
    evaluation_for,
)
from deepprior_tpu_torch.eval.metrics import HandposeEvaluation

__all__ = [
    "HandposeEvaluation",
    "ICVLHandposeEvaluation",
    "NYUHandposeEvaluation",
    "NYUAllHandposeEvaluation",
    "MSRAHandposeEvaluation",
    "evaluation_for",
]

"""Evaluation: the hand-pose metric suite."""

from deepprior_tpu_torch.eval.metrics import HandposeEvaluation

__all__ = ["HandposeEvaluation"]

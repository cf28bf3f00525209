"""≙ paddle_tpu/evaluator.py (reference python/paddle/fluid/evaluator.py):
the deprecated Evaluator aliases the reference kept for compatibility; the
classes live in paddle_tpu_torch.metrics."""

from .metrics import (Accuracy, Auc, ChunkEvaluator,  # noqa: F401
                      DetectionMAP, EditDistance, Precision, Recall)

__all__ = ["Accuracy", "Auc", "ChunkEvaluator", "DetectionMAP",
           "EditDistance", "Precision", "Recall"]

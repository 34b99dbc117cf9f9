"""Counterfactual and classifier metrics, figures and reports (mirrors
`cfgan/eval`)."""
from cfgan_torch.eval.metrics import (
    evaluate_counterfactual_batch,
    make_per_target_sweep,
    masked_metrics,
    per_target_metrics,
)
from cfgan_torch.eval.classifier import evaluate_classifier

__all__ = [
    "evaluate_counterfactual_batch",
    "make_per_target_sweep",
    "masked_metrics",
    "per_target_metrics",
    "evaluate_classifier",
]

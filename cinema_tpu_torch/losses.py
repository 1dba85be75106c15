"""Task losses of the fine-tuning heads (port of cinema_tpu/losses.py, the
classification and regression parts; reference cinema/classification/train.py:82-110
and cinema/regression/train.py:21-55). Plain torch, float32 inside."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not ``ignore_index``
    (0 when there is none), with torch's label smoothing.

    Args:
        logits: (batch, *spatial, n_classes), classes last.
        labels: (batch, *spatial) ints.
    """
    n_classes = logits.shape[-1]
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    log_probs = F.log_softmax(logits.float(), dim=-1)
    target = F.one_hot(safe, n_classes).float()
    if label_smoothing > 0:
        target = target * (1.0 - label_smoothing) + label_smoothing / n_classes
    ce = -(target * log_probs).sum(-1)
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    return ce.sum() / valid.sum().clamp(min=1)


def classification_loss(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.1
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross entropy with label smoothing on (batch, n_classes) logits."""
    ce = cross_entropy(logits, labels, ignore_index=-1, label_smoothing=label_smoothing)
    return ce, {"cross_entropy": ce, "loss": ce}


def regression_loss(preds: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean squared error on (z-normalised) targets."""
    loss = (preds.float() - targets.float()).square().mean()
    return loss, {"mse_loss": loss, "loss": loss}

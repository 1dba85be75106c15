"""Evaluation metrics of the classification and regression heads (port of
cinema_tpu/metrics.py ``classification_metrics`` and ``regression_metrics``;
reference cinema/classification/train.py:183-295, cinema/regression/train.py:183-222).

Host-side numpy. The JAX package delegates to scikit-learn; the formulas are
written out here (confusion matrix, F1, Matthews correlation, rank-based ROC
AUC with ties averaged, one-vs-one macro AUC over the classes present), so
the machine with the card needs no scikit-learn.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict

import numpy as np


def confusion_matrix(true_labels: np.ndarray, pred_labels: np.ndarray, n_classes: int) -> np.ndarray:
    """(n_classes, n_classes) counts, rows true and columns predicted."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(true_labels, dtype=np.int64), np.asarray(pred_labels, dtype=np.int64)), 1)
    return cm


def matthews_corrcoef(cm: np.ndarray) -> float:
    """Multiclass Matthews correlation from a confusion matrix; 0 where it is undefined."""
    t_sum, p_sum = cm.sum(axis=1).astype(np.float64), cm.sum(axis=0).astype(np.float64)
    n = float(cm.sum())
    cov_tp = float(np.trace(cm)) * n - float(t_sum @ p_sum)
    cov_pp = n * n - float(p_sum @ p_sum)
    cov_tt = n * n - float(t_sum @ t_sum)
    if cov_pp * cov_tt == 0:
        return 0.0
    return cov_tp / np.sqrt(cov_pp * cov_tt)


def binary_roc_auc(positive: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve: the share of (positive, negative) pairs that
    the score orders rightly, ties counting half (the Mann-Whitney statistic)."""
    positive = np.asarray(positive, dtype=bool)
    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inverse]  # average rank, 1-based
    n_pos, n_neg = int(positive.sum()), int((~positive).sum())
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def classification_metrics(
    true_labels: np.ndarray, pred_labels: np.ndarray, pred_probs: np.ndarray
) -> Dict[str, float]:
    """Binary: accuracy/entropy/specificity/sensitivity/f1/mcc/roc_auc.
    Multiclass: accuracy/entropy/f1 (micro)/mcc/roc_auc (macro, one-vs-one).

    Args:
        true_labels, pred_labels: (n,) ints; pred_probs: (n, n_classes).
    """
    true_labels, pred_labels = np.asarray(true_labels), np.asarray(pred_labels)
    n_classes = pred_probs.shape[1]
    cm = confusion_matrix(true_labels, pred_labels, n_classes)
    several = len(np.unique(true_labels)) > 1
    metrics: Dict[str, float] = {
        "accuracy": float(np.trace(cm) / cm.sum()),
        "entropy": float(-np.mean(np.sum(pred_probs * np.log(pred_probs + 1e-6), axis=1))),
    }
    if n_classes == 2:
        tn, fp, fn, tp = (int(x) for x in cm.ravel())
        metrics["specificity"] = float(tn / (tn + fp)) if (tn + fp) else 0.0
        metrics["sensitivity"] = float(tp / (tp + fn)) if (tp + fn) else 0.0
        metrics["f1"] = float(2 * tp / (2 * tp + fp + fn)) if (2 * tp + fp + fn) else 0.0
        metrics["mcc"] = float(matthews_corrcoef(cm)) if several else 0.0
        metrics["roc_auc"] = binary_roc_auc(true_labels == 1, pred_probs[:, 1]) if several else 0.0
        return metrics
    # micro-averaged F1 over all classes is the accuracy
    metrics["f1"] = metrics["accuracy"]
    metrics["mcc"] = float(matthews_corrcoef(cm)) if several else 0.0
    if several:
        pair_scores = []
        for a, b in combinations(np.unique(true_labels), 2):
            sel = (true_labels == a) | (true_labels == b)
            auc_a = binary_roc_auc(true_labels[sel] == a, pred_probs[sel, a])
            auc_b = binary_roc_auc(true_labels[sel] == b, pred_probs[sel, b])
            pair_scores.append((auc_a + auc_b) / 2.0)
        metrics["roc_auc"] = float(np.mean(pair_scores))
    else:
        metrics["roc_auc"] = 0.0
    return metrics


def regression_metrics(
    true_values: np.ndarray, pred_values: np.ndarray, mean: float = 0.0, std: float = 1.0, prefix: str = ""
) -> Dict[str, float]:
    """RMSE and MAE on the normalised values and scaled back by ``std``."""
    err = np.asarray(pred_values) - np.asarray(true_values)
    denorm_err = err * std
    return {
        f"{prefix}rmse": float(np.sqrt(np.mean(err**2))),
        f"{prefix}mae": float(np.mean(np.abs(err))),
        f"{prefix}denormalised_rmse": float(np.sqrt(np.mean(denorm_err**2))),
        f"{prefix}denormalised_mae": float(np.mean(np.abs(denorm_err))),
    }

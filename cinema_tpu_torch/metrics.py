"""Evaluation metrics of the segmentation, classification, regression and landmark
heads (port of cinema_tpu/metrics.py; reference cinema/metric.py and the MONAI and
scikit-learn calls of cinema/segmentation/train.py:224-286,
cinema/classification/train.py:183-295 and cinema/regression/train.py:183-222).

The segmentation metrics that reduce a volume (Dice, IoU, stability, volumes)
are torch on the logits' device; the 95th-percentile Hausdorff distance runs on
the host with ``scipy.ndimage``, as the JAX package runs it. The classification
and regression metrics are host-side numpy: the JAX package delegates them to
scikit-learn, and here the formulas are written out (confusion matrix, F1,
Matthews correlation, rank-based ROC AUC with ties averaged, one-vs-one macro
AUC over the classes present), so the machine with the card needs no
scikit-learn.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, Sequence, Union

import numpy as np
import torch
from scipy import ndimage

from cinema_tpu_torch.constants import NORMAL_EF, REDUCED_EF

ArrayLike = Union[torch.Tensor, np.ndarray, float]


def one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """One-hot float32 along a new last axis: (batch, ...) -> (batch, ..., n_classes); a label
    outside [0, n_classes), such as -1, gives a row of zeros."""
    return (labels.long()[..., None] == torch.arange(n_classes, device=labels.device)).float()


def dice_score(pred_mask: torch.Tensor, true_mask: torch.Tensor) -> torch.Tensor:
    """Per-class Dice of one-hot masks (batch, *spatial, n_classes) -> (batch, n_classes);
    NaN where the class is absent from both."""
    axes = tuple(range(1, pred_mask.ndim - 1))
    inter = (pred_mask * true_mask).sum(axes)
    denom = pred_mask.sum(axes) + true_mask.sum(axes)
    return torch.where(denom > 0, 2.0 * inter / denom, torch.nan)


def iou_score(pred_mask: torch.Tensor, true_mask: torch.Tensor) -> torch.Tensor:
    """Per-class IoU of one-hot masks (batch, *spatial, n_classes) -> (batch, n_classes);
    NaN where the class is absent from both."""
    axes = tuple(range(1, pred_mask.ndim - 1))
    inter = (pred_mask * true_mask).sum(axes)
    union = torch.maximum(pred_mask, true_mask).sum(axes)
    return torch.where(union > 0, inter / union, torch.nan)


def stability_score(logits: torch.Tensor, threshold: float = 0.0, threshold_offset: float = 1.0) -> torch.Tensor:
    """SAM-style prediction stability (reference metric.py:19-42): the IoU between the masks of
    the class-centred logits above ``threshold`` + and - ``threshold_offset``, (batch, n_classes)."""
    normalized = logits - logits.mean(dim=-1, keepdim=True)
    high = (normalized >= threshold + threshold_offset).float()
    low = (normalized >= threshold - threshold_offset).float()
    return iou_score(high, low)


def get_volumes(mask: torch.Tensor, spacing: Sequence[float]) -> torch.Tensor:
    """Per-class volumes in ml of one-hot masks (batch, *spatial, n_classes), voxel spacing in mm
    (reference metric.py:84-96)."""
    axes = tuple(range(1, mask.ndim - 1))
    return mask.sum(axes) * float(np.prod(np.asarray(spacing))) / 1000.0


def ejection_fraction(edv: ArrayLike, esv: ArrayLike) -> ArrayLike:
    """EF in percent (reference metric.py:99-112)."""
    return (edv - esv) / edv * 100.0


def get_ef_region(x: float) -> int:
    """EF region: 0 reduced (<= 40), 1 borderline (<= 55), 2 normal (reference metric.py:133-146)."""
    if x <= REDUCED_EF:
        return 0
    if x <= NORMAL_EF:
        return 1
    return 2


def coefficient_of_variance(x: np.ndarray, y: np.ndarray) -> float:
    """Scan-rescan reproducibility CV (reference metric.py:115-130)."""
    s2 = (x - y) ** 2 / 2
    m = (x + y) / 2
    return float(np.sqrt(np.mean(s2 / m**2)))


def _surface(mask: np.ndarray) -> np.ndarray:
    """The edge voxels of a binary mask."""
    return mask & ~ndimage.binary_erosion(mask)


def hausdorff_distance_95(
    pred_mask: np.ndarray, true_mask: np.ndarray, spacing: Sequence[float], percentile: float = 95.0
) -> np.ndarray:
    """Symmetric 95th-percentile Hausdorff distance per foreground class, on the host.

    MONAI's ``compute_hausdorff_distance`` as the reference calls it
    (segmentation/train.py:262-267): surface-to-surface distances with the voxel
    spacing, the larger of the two directed percentiles; NaN where either mask is empty.

    Args:
        pred_mask, true_mask: (batch, *spatial, n_classes) one-hot, numpy.
        spacing: voxel spacing in mm.

    Returns:
        (batch, n_classes - 1) float64 for the classes 1..n-1.
    """
    pred_mask = np.asarray(pred_mask).astype(bool)
    true_mask = np.asarray(true_mask).astype(bool)
    batch, *_, n_classes = pred_mask.shape
    out = np.full((batch, n_classes - 1), np.nan, dtype=np.float64)
    spacing = tuple(float(s) for s in spacing)
    for b in range(batch):
        for c in range(1, n_classes):
            p, t = pred_mask[b, ..., c], true_mask[b, ..., c]
            if not p.any() or not t.any():
                continue
            ps, ts = _surface(p), _surface(t)
            if not ps.any() or not ts.any():
                out[b, c - 1] = 0.0
                continue
            d_pt = ndimage.distance_transform_edt(~ts, sampling=spacing)[ps]
            d_tp = ndimage.distance_transform_edt(~ps, sampling=spacing)[ts]
            out[b, c - 1] = max(np.percentile(d_pt, percentile), np.percentile(d_tp, percentile))
    return out


def heatmap_argmax(heatmap: torch.Tensor) -> torch.Tensor:
    """Hard argmax coordinates of channels-last heatmaps (reference metric.py:45-59): (batch, x, y, c) ->
    (batch, 2c) int64 [x0, y0, x1, y1, ...], the first maximum where several are equal."""
    batch, w, h, c = heatmap.shape
    idx = heatmap.reshape(batch, w * h, c).argmax(dim=1)  # (batch, c)
    return torch.stack([idx // h, idx % h], dim=-1).reshape(batch, 2 * c)


def heatmap_soft_argmax(heatmap: torch.Tensor, beta: float = 1000.0) -> torch.Tensor:
    """Soft-argmax coordinates of channels-last heatmaps (reference metric.py:62-81): the expected (x, y)
    under ``softmax(beta * heatmap)`` over the positions, (batch, x, y, c) -> (batch, 2c), truncated to int32."""
    batch, w, h, c = heatmap.shape
    probs = torch.softmax(heatmap.reshape(batch, w * h, c) * beta, dim=1)
    xs, ys = torch.meshgrid(torch.arange(w, device=heatmap.device), torch.arange(h, device=heatmap.device),
                            indexing="ij")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(probs.dtype)  # (w*h, 2)
    return torch.einsum("bnc,nd->bcd", probs, coords).reshape(batch, 2 * c).to(torch.int32)


def segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor, spacing: Sequence[float]) -> Dict[str, np.ndarray]:
    """The segmentation metric suite (reference segmentation/train.py:224-286).

    Dice, IoU, stability and the volumes are computed on the logits' device and
    read back in one copy; the Hausdorff distance takes the two label maps to the host.

    Args:
        logits: (batch, *spatial, 1 + n_fg_classes) channels-last.
        labels: (batch, *spatial) integer labels.
        spacing: voxel spacing in mm.

    Returns:
        per metric name a (batch,) array: ``class_{c}_{dice_score, iou_score, stability_score,
        hausdorff_distance_95, true_volume, pred_volume}`` for every foreground class c and
        ``mean_{dice_score, iou_score, stability_score, hausdorff_distance_95}`` over them.
    """
    n_classes = logits.shape[-1]
    logits = logits.float()
    pred_labels = logits.argmax(dim=-1)
    pred_mask, true_mask = one_hot(pred_labels, n_classes), one_hot(labels, n_classes)
    dice, iou, stability, true_volumes, pred_volumes = torch.stack([
        dice_score(pred_mask, true_mask), iou_score(pred_mask, true_mask), stability_score(logits),
        get_volumes(true_mask, spacing), get_volumes(pred_mask, spacing),
    ]).cpu().numpy()
    classes = np.arange(n_classes)
    hd95 = hausdorff_distance_95(pred_labels.cpu().numpy()[..., None] == classes,
                                 labels.long().cpu().numpy()[..., None] == classes, spacing)

    metrics: Dict[str, np.ndarray] = {}
    for cls in range(1, n_classes):
        metrics[f"class_{cls}_dice_score"] = dice[:, cls]
        metrics[f"class_{cls}_iou_score"] = iou[:, cls]
        metrics[f"class_{cls}_stability_score"] = stability[:, cls]
        metrics[f"class_{cls}_hausdorff_distance_95"] = hd95[:, cls - 1]
        metrics[f"class_{cls}_true_volume"] = true_volumes[:, cls]
        metrics[f"class_{cls}_pred_volume"] = pred_volumes[:, cls]
    metrics["mean_dice_score"] = dice[:, 1:].mean(axis=-1)
    metrics["mean_iou_score"] = iou[:, 1:].mean(axis=-1)
    metrics["mean_stability_score"] = stability[:, 1:].mean(axis=-1)
    metrics["mean_hausdorff_distance_95"] = np.nanmean(hd95, axis=-1) if hd95.size else hd95
    return metrics


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

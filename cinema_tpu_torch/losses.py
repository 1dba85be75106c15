"""Task losses of the fine-tuning heads (port of cinema_tpu/losses.py; reference
cinema/segmentation/train.py:77-103, cinema/classification/train.py:82-110,
cinema/regression/train.py:21-55, cinema/segmentation/landmark/train.py:109-132
and cinema/regression/landmark/train.py:46-152). Plain torch, float32 inside."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
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


def soft_dice_loss(
    probs: torch.Tensor,
    target: torch.Tensor,
    include_background: bool = False,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
) -> torch.Tensor:
    """MONAI-style soft Dice loss, channels-last: the mean over batch and classes of 1 - Dice.

    Args:
        probs: (batch, *spatial, n_classes) probabilities.
        target: (batch, *spatial, n_classes) one-hot (or soft) targets.
        include_background: keep class 0 in the mean.
    """
    if not include_background:
        probs, target = probs[..., 1:], target[..., 1:]
    axes = tuple(range(1, probs.ndim - 1))
    inter = (probs * target).sum(axes)
    denom = probs.sum(axes) + target.sum(axes)
    dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
    return (1.0 - dice).mean()


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross entropy ignoring label -1, plus soft Dice without background on the float32 softmax.
    The Dice target is the one-hot of ``max(label, 0)``: an ignored voxel counts as background there.

    Args:
        logits: (batch, *spatial, n_classes) channels-last.
        labels: (batch, *spatial) ints, -1 = ignore.
    """
    n_classes = logits.shape[-1]
    mask = F.one_hot(labels.long().clamp(min=0), n_classes).float()
    ce = cross_entropy(logits, labels, ignore_index=-1)
    dice = soft_dice_loss(torch.softmax(logits.float(), dim=-1), mask, include_background=False)
    loss = dice + ce
    return loss, {"cross_entropy": ce, "mean_dice_loss": dice, "loss": loss}


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


def landmark_heatmap_loss(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Independent-channel sigmoid soft Dice (background included) plus the stable binary cross entropy
    ``max(x, 0) - x * y + log1p(exp(-|x|))``.

    Args:
        logits: (batch, *spatial, 3) channels-last heatmap logits.
        labels: the same shape, in [0, 1].
    """
    logits, labels = logits.float(), labels.float()
    dice = soft_dice_loss(torch.sigmoid(logits), labels, include_background=True)
    bce = (logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()
    loss = dice + bce
    return loss, {"bce_loss": bce, "dice_loss": dice, "loss": loss}


def wing_loss(pred: torch.Tensor, target: torch.Tensor, w: float = 10.0, epsilon: float = 2.0) -> torch.Tensor:
    """Mean Wing loss: ``w * log1p(|e| / epsilon)`` below ``w``, ``|e| - c`` above, continuous at ``w``."""
    c = w - w * math.log(1 + w / epsilon)
    err = (pred.float() - target.float()).abs()
    return torch.where(err < w, w * torch.log1p(err / epsilon), err - c).mean()


# each landmark's coordinate minus the mean of the other two landmarks' (x and y apart)
_REL_DIST_MATRIX = np.array(
    [
        [1, 0, -0.5, 0, -0.5, 0],
        [0, 1, 0, -0.5, 0, -0.5],
        [-0.5, 0, 1, 0, -0.5, 0],
        [0, -0.5, 0, 1, 0, -0.5],
        [-0.5, 0, -0.5, 0, 1, 0],
        [0, -0.5, 0, -0.5, 0, 1],
    ],
    dtype=np.float32,
)


def get_relative_distances(coords: torch.Tensor) -> torch.Tensor:
    """Point-to-midpoint-of-the-others offsets of (batch, 6) coordinates [x0, y0, x1, y1, x2, y2]."""
    return coords @ torch.as_tensor(_REL_DIST_MATRIX, dtype=coords.dtype, device=coords.device)


def landmark_coordinate_loss(
    pred_coords: torch.Tensor, true_coords: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Wing loss of the coordinates plus Wing loss of their relative distances.

    Args:
        pred_coords, true_coords: (batch, 6) in image units.
    """
    pred_rel, true_rel = get_relative_distances(pred_coords), get_relative_distances(true_coords)
    lm = wing_loss(pred_coords, true_coords)
    rel = wing_loss(pred_rel, true_rel)
    loss = lm + rel
    return loss, {
        "landmark_wing_loss": lm,
        "relative_distance_wing_loss": rel,
        "landmark_mae": (pred_coords - true_coords).abs().mean(),
        "relative_distance_mae": (pred_rel - true_rel).abs().mean(),
        "loss": loss,
    }

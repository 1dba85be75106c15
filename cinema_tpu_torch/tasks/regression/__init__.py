"""Shared regression training and evaluation (port of cinema_tpu/tasks/regression/__init__.py;
reference cinema/regression/train.py)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.losses import regression_loss
from cinema_tpu_torch.metrics import regression_metrics
from cinema_tpu_torch.tasks.classification import (
    batch_images,
    get_classification_model,
    patched_forward,
    view_patch_sizes,
)

get_regression_model = get_classification_model  # the same dispatch on config.model.name


def regression_loss_fn(
    model: nn.Module, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean squared error on z-normalised targets (reference regression/train.py:21-55)."""
    return regression_loss(model(batch_images(batch))[:, 0], batch["label"])


def regression_forward(
    forward: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    image_dict: Dict[str, torch.Tensor],
    patch_size_dict: Dict[str, Tuple[int, ...]],
) -> torch.Tensor:
    """Predictions, or over patches their mean (reference regression/train.py:58-120)."""
    preds, patched = patched_forward(forward, image_dict, patch_size_dict)
    return preds.float().mean(dim=0, keepdim=True) if patched else preds


@torch.no_grad()
def regression_eval_dataloader(
    model: nn.Module, dataloader: Iterable[Dict[str, np.ndarray]], config: Config
) -> Dict[str, float]:
    """RMSE and MAE over a batch-1 loader, normalised and scaled back by
    ``config.data.<regression_column>.std`` (reference regression/train.py:123-222).
    The model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    patch_size_dict = view_patch_sizes(config)
    true_vals: List[float] = []
    preds: List[torch.Tensor] = []
    for batch in dataloader.epoch(0):
        image_dict = {v: torch.from_numpy(batch[f"{v}_image"]).to(device) for v in patch_size_dict}
        preds.append(regression_forward(model, image_dict, patch_size_dict).float().reshape(-1)[0])
        true_vals.append(float(np.asarray(batch["label"]).reshape(-1)[0]))
    pred_vals = torch.stack(preds).cpu().numpy()  # the evaluation's one read from the device
    reg_std = 1.0
    col = config.data.get("regression_column")
    if col and col in config.data:
        reg_std = float(config.data[col]["std"])
    return regression_metrics(np.asarray(true_vals), pred_vals, std=reg_std)

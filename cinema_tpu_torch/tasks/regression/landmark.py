"""Landmark coordinate regression (port of cinema_tpu/tasks/regression/landmark.py;
reference cinema/regression/landmark/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.regression.landmark [--config landmark.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvViT-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["regression/landmark"]``: the 2-D ``lax_2c``
view at 256x256, one frame, six outputs); ``data.dir=...`` names the data,
``model.ckpt_path=...`` pretrained MAE weights (safetensors),
``train.resume_path=...`` a checkpoint to resume from.

Data: the layout of ``cinema_tpu_torch.tasks.segmentation.landmark`` (metadata
tables and PNGs). The label is the six coordinates divided by
the image's width and height; the loss is the Wing loss of the coordinates and
of their relative distances, in pixels. As in the JAX package no transform is
applied and the evaluation runs one plain forward per image, so every image
must be of exactly ``data.lax.patch_size``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import LandmarkRegressionDataset, read_metadata
from cinema_tpu_torch.losses import landmark_coordinate_loss
from cinema_tpu_torch.tasks.classification import get_classification_model
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train


def _scales(batch: Dict[str, torch.Tensor], view: str) -> torch.Tensor:
    """(batch, 6) float32 [w, h, w, h, w, h] of the images."""
    w, h = batch[f"{view}_width"].float(), batch[f"{view}_height"].float()
    return torch.stack([w, h, w, h, w, h], dim=-1)


def landmark_regression_loss_fn(
    model: nn.Module, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Wing loss of the coordinates and of their relative distances, in pixels
    (reference regression/landmark/train.py:108-152)."""
    view = sorted(k[: -len("_image")] for k in batch if k.endswith("_image"))[0]
    preds = model({view: batch[f"{view}_image"]})
    scales = _scales(batch, view)
    return landmark_coordinate_loss(preds * scales, batch["label"] * scales)


@torch.no_grad()
def landmark_regression_eval_dataloader(model: nn.Module, dataloader: Any, config: Config) -> Dict[str, float]:
    """The mean absolute coordinate error and the mean Euclidean landmark distance, in pixels, over a
    batch-1 loader: one plain forward per image, no sliding window (reference
    regression/landmark/train.py). The model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    view = config.model.views if isinstance(config.model.views, str) else config.model.views[0]
    preds: List[torch.Tensor] = []
    scales: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for batch in dataloader.epoch(0):
        preds.append(model({view: torch.from_numpy(batch[f"{view}_image"]).to(device)}).float())
        scales.append(_scales({k: torch.from_numpy(batch[k]) for k in (f"{view}_width", f"{view}_height")},
                              view).numpy())
        labels.append(batch["label"])
    pred_vals = torch.cat(preds).cpu().numpy()  # the evaluation's one read from the device
    errors, dists = [], []
    for pred, scale, label in zip(np.split(pred_vals, len(labels)), scales, labels):
        diff = pred * scale - label * scale
        errors.append(np.abs(diff).mean())
        dists.append(np.sqrt((diff.reshape(-1, 3, 2) ** 2).sum(-1)).mean())
    return {"mean_coordinate_error": float(np.mean(errors)), "mean_landmark_distance": float(np.mean(dists))}


def load_dataset(config: Config) -> Tuple[LandmarkRegressionDataset, LandmarkRegressionDataset]:
    data_dir = Path(config.data.dir).expanduser()
    view = config.model.views if isinstance(config.model.views, str) else config.model.views[0]
    train, val = maybe_subset_dataset(config, read_metadata(data_dir / "train_metadata.csv"),
                                      read_metadata(data_dir / "val_metadata.csv"))
    return LandmarkRegressionDataset(data_dir, train, view), LandmarkRegressionDataset(data_dir, val, view)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(
        config=config,
        load_dataset=load_dataset,
        get_model_fn=get_classification_model,
        loss_fn=landmark_regression_loss_fn,
        eval_dataloader_fn=landmark_regression_eval_dataloader,
        load_pretrained_fn=load_pretrained,
        out_dir=out_dir,
        device=device,
    )


def main(argv: Union[List[str], None] = None) -> None:
    task_main("regression/landmark", run, __doc__, argv)


if __name__ == "__main__":
    main()

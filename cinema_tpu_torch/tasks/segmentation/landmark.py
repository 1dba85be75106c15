"""Landmark heatmap detection (port of cinema_tpu/tasks/segmentation/landmark.py;
reference cinema/segmentation/landmark/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.landmark [--config landmark.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvUNetR-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["segmentation/landmark"]``: the 2-D
``lax_2c`` view at 256x256, three sigmoid heatmap channels); ``data.dir=...``
names the data, ``model.ckpt_path=...`` pretrained MAE weights (safetensors),
``train.resume_path=...`` a checkpoint to resume from.

Data: ``data.dir`` holds ``train_metadata.csv`` and ``val_metadata.csv`` (columns
``path``, ``x1``..``y3`` and optionally ``view``, whose other views' rows are left
out) and the PNGs they name relative to ``data.dir``, as
cinema_tpu/data/preprocess/landmark.py writes them (``lax_2c/images/<uid>.png``; any PNG
is read as PIL's ``convert("L")`` reads it, ``data/png.py``).
The label of an image is the Gaussian heatmap (sigma 3) of its three landmarks.
As in the JAX package no transform is applied: images keep their 0-255
intensities and their size, so training images must be of exactly
``data.lax.patch_size``; a larger validation image is evaluated by sliding window.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import LandmarkDetectionDataset, read_metadata
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.inference import sliding_window_forward
from cinema_tpu_torch.losses import landmark_heatmap_loss
from cinema_tpu_torch.metrics import heatmap_argmax
from cinema_tpu_torch.ops.window import crop_start
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.segmentation import patch_and_spacing_dicts
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train


def landmark_loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over views of the sigmoid Dice + BCE of the heatmaps (reference
    segmentation/landmark/train.py:109-132); the per-view metrics under ``{view}_`` and the mean ``loss``."""
    views = sorted(k[: -len("_image")] for k in batch if k.endswith("_image"))
    logits_dict = model({v: batch[f"{v}_image"] for v in views})
    metrics: Dict[str, torch.Tensor] = {}
    losses = []
    for view, logits in logits_dict.items():
        loss_view, metrics_view = landmark_heatmap_loss(logits, batch[f"{view}_label"])
        losses.append(loss_view)
        metrics.update({f"{view}_{k}": v for k, v in metrics_view.items()})
    loss = sum(losses) / len(losses)
    metrics["loss"] = loss
    return loss, metrics


def landmark_eval_batch(
    forward, batch: Mapping[str, Any], view: str, patch_size: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """One batch-1 image: the sigmoid sliding window at ``patch_size``, both heatmaps cropped to the
    image's width and height, and their argmax coordinates.

    Args:
        forward: batched forward, image_dict -> logits_dict (channels-last).
        batch: ``{view}_image`` (1, x, y, 1) on the forward's device; ``{view}_label`` (1, x, y, 3),
            ``{view}_width`` and ``{view}_height`` as anything numpy reads.

    Returns:
        the cropped (1, width, height, 3) logits, the (1, 6) predicted coordinates on the logits'
        device, and the (1, 6) true coordinates on the host.
    """
    logits = sliding_window_forward(forward, {view: batch[f"{view}_image"]}, {view: patch_size}, "sigmoid")[view]
    width = int(np.asarray(batch[f"{view}_width"]).reshape(-1)[0])
    height = int(np.asarray(batch[f"{view}_height"]).reshape(-1)[0])
    logits = crop_start(logits, (1, width, height, logits.shape[-1]))
    label = crop_start(torch.as_tensor(np.asarray(batch[f"{view}_label"])), (1, width, height, 3))
    return logits, heatmap_argmax(logits), heatmap_argmax(label).numpy()


@torch.no_grad()
def landmark_eval_dataloader(model: nn.Module, dataloader: Any, config: Config) -> Dict[str, float]:
    """The mean absolute coordinate error and the mean Euclidean landmark distance, in pixels, of the
    heatmaps' argmax over a batch-1 loader (reference segmentation/landmark/train.py:135-260), computed
    in float64 on the host. The model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    patch_size_dict, _ = patch_and_spacing_dicts(config)
    view = next(iter(patch_size_dict))
    preds: List[torch.Tensor] = []
    trues: List[np.ndarray] = []
    for batch in dataloader.epoch(0):
        batch = dict(batch, **{f"{view}_image": torch.from_numpy(batch[f"{view}_image"]).to(device)})
        _, pred, true = landmark_eval_batch(model, batch, view, patch_size_dict[view])
        preds.append(pred)
        trues.append(true)
    pred_coords = torch.cat(preds).cpu().numpy()  # the evaluation's one read from the device
    diff = (pred_coords - np.concatenate(trues)).astype(np.float64)
    return {
        "mean_coordinate_error": float(np.abs(diff).mean(axis=1).mean()),
        "mean_landmark_distance": float(np.sqrt((diff.reshape(-1, 3, 2) ** 2).sum(-1)).mean(axis=1).mean()),
    }


def load_dataset(config: Config) -> Tuple[LandmarkDetectionDataset, LandmarkDetectionDataset]:
    data_dir = Path(config.data.dir).expanduser()
    view = config.model.views if isinstance(config.model.views, str) else config.model.views[0]
    train, val = maybe_subset_dataset(config, read_metadata(data_dir / "train_metadata.csv"),
                                      read_metadata(data_dir / "val_metadata.csv"))
    return LandmarkDetectionDataset(data_dir, train, view), LandmarkDetectionDataset(data_dir, val, view)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(
        config=config,
        load_dataset=load_dataset,
        get_model_fn=get_segmentation_model,
        loss_fn=landmark_loss_fn,
        eval_dataloader_fn=landmark_eval_dataloader,
        load_pretrained_fn=load_pretrained,
        out_dir=out_dir,
        device=device,
    )


def main(argv: Union[List[str], None] = None) -> None:
    task_main("segmentation/landmark", run, __doc__, argv)


if __name__ == "__main__":
    main()

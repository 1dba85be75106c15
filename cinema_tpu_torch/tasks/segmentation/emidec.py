"""EMIDEC myocardial infarction segmentation with grouped-class metrics (port of
cinema_tpu/tasks/segmentation/emidec.py; reference cinema/segmentation/emidec/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.emidec [--config emidec.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvUNetR-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["segmentation/emidec"]``: 96x96x8 patches at 1.458 mm,
five classes); ``data.dir=...`` names the data, ``model.ckpt_path=...`` pretrained MAE
weights (safetensors), ``train.resume_path=...`` a checkpoint to resume from.

Data: ``data.dir`` holds ``train_metadata.csv`` (``pid``, ``n_slices``) and per study
``train/<pid>/<pid>.nii.gz`` with its label ``<pid>_gt.nii.gz`` (0 background, 1 cavity,
2 myocardium, 3 infarct, 4 no-reflow). Two studies of each pid prefix (``Case_N``, ``Case_P``)
are held out for validation, those that the JAX package's pandas draws. Training items are
augmented as the config's ``transform`` section says; a validation study is evaluated by
sliding window at its own size with the grouped-class metrics.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import EMIDECDataset, read_metadata
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.metrics import dice_score, get_volumes, hausdorff_distance_95, iou_score
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.segmentation import segmentation_eval_dataloader, segmentation_loss_fn
from cinema_tpu_torch.train.loop import groupby_sample, maybe_subset_dataset, run_train


def _grouped_masks(labels: torch.Tensor) -> torch.Tensor:
    """The EMIDEC classes as nested masks, (batch, *spatial) -> (batch, *spatial, 5) float32: background,
    cavity, myocardium (>= 2), infarct (>= 3), no-reflow (4) (reference emidec/train.py:162-180)."""
    return torch.stack([labels == 0, labels == 1, labels >= 2, labels >= 3, labels == 4], dim=-1).float()


def emidec_segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor,
                                spacing: Sequence[float]) -> Dict[str, np.ndarray]:
    """Dice (1 where a grouped class is absent from both the prediction and the label), IoU, HD95 and the
    true and predicted volumes of the four grouped classes, and the means over them, each (batch,)
    (reference emidec/train.py:139-220). Dice, IoU and the volumes on the logits' device, HD95 on the host."""
    true_mask = _grouped_masks(labels.long())
    pred_mask = _grouped_masks(logits.argmax(dim=-1))
    axes = tuple(range(1, true_mask.ndim - 1))
    both_empty = (true_mask.sum(axes) + pred_mask.sum(axes)) == 0
    dice = torch.where(both_empty, 1.0, dice_score(pred_mask, true_mask))
    dice, iou, true_volumes, pred_volumes = torch.stack([
        dice, iou_score(pred_mask, true_mask), get_volumes(true_mask, spacing), get_volumes(pred_mask, spacing),
    ]).cpu().numpy()
    hd95 = hausdorff_distance_95(pred_mask.bool().cpu().numpy(), true_mask.bool().cpu().numpy(), spacing)
    metrics: Dict[str, np.ndarray] = {}
    for cls in range(1, 5):
        metrics[f"class_{cls}_dice_score"] = dice[:, cls]
        metrics[f"class_{cls}_iou_score"] = iou[:, cls]
        metrics[f"class_{cls}_hausdorff_distance_95"] = hd95[:, cls - 1]
        metrics[f"class_{cls}_true_volume"] = true_volumes[:, cls]
        metrics[f"class_{cls}_pred_volume"] = pred_volumes[:, cls]
    metrics["mean_dice_score"] = np.nanmean(dice[:, 1:], axis=-1)
    metrics["mean_iou_score"] = np.nanmean(iou[:, 1:], axis=-1)
    metrics["mean_hausdorff_distance_95"] = np.nanmean(hd95, axis=-1)
    return metrics


def load_dataset(config: Config) -> Tuple[EMIDECDataset, EMIDECDataset]:
    """(train, val): the two studies of each pid prefix (``pid[:6]``, normal or pathological) that pandas'
    ``groupby(...).sample(n=2, random_state=0)`` draws go to validation, in drawn order; then the
    ``max_n_samples`` cap and the ``proportion``."""
    data_dir = Path(config.data.dir).expanduser()
    rows = read_metadata(data_dir / "train_metadata.csv")
    val_ids = groupby_sample([str(r["pid"])[:6] for r in rows], 2)
    held = set(val_ids)
    train, val = maybe_subset_dataset(config, [r for i, r in enumerate(rows) if i not in held],
                                      [rows[i] for i in val_ids])
    train_transform, val_transform = get_segmentation_transforms(config)
    return (EMIDECDataset(data_dir / "train", train, train_transform),
            EMIDECDataset(data_dir / "train", val, val_transform))


emidec_eval_dataloader = partial(segmentation_eval_dataloader, metrics_fn=emidec_segmentation_metrics)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(config=config, load_dataset=load_dataset, get_model_fn=get_segmentation_model,
                     loss_fn=segmentation_loss_fn, eval_dataloader_fn=emidec_eval_dataloader,
                     load_pretrained_fn=load_pretrained, out_dir=out_dir, device=device)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("segmentation/emidec", run, __doc__, argv)


if __name__ == "__main__":
    main()

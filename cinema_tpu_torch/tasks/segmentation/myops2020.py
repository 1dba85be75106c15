"""MyoPS2020 multi-sequence scar segmentation with grouped-class metrics (port of
cinema_tpu/tasks/segmentation/myops2020.py; reference cinema/segmentation/myops2020/train.py, eval.py).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.myops2020 [--config myops2020.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvUNetR-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["segmentation/myops2020"]``: bSSFP, LGE and T2 as three
input channels, 192x192x4 patches); ``data.dir=...`` names the data, ``model.ckpt_path=...``
pretrained MAE weights (safetensors), ``train.resume_path=...`` a checkpoint to resume from.

Data: ``data.dir`` holds ``train_metadata.csv`` (``pid``, an integer, and ``n_slices``) and per
study ``train/<pid>/<pid>_{c0,de,t2}.nii.gz`` with its label ``<pid>_gt.nii.gz`` (0 background,
1 myocardium, 2 edema, 3 scar). A tenth of the studies (at least two), those that the JAX
package's pandas draws, are held out for validation. Training items are augmented as the
config's ``transform`` section says; a validation study is evaluated by sliding window at its
own size with the grouped-class metrics.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import MYOPS2020Dataset, read_metadata
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.metrics import dice_score, hausdorff_distance_95, iou_score
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.segmentation import segmentation_eval_dataloader, segmentation_loss_fn
from cinema_tpu_torch.train.loop import pandas_sample, maybe_subset_dataset, run_train


def _grouped_masks(labels: torch.Tensor) -> torch.Tensor:
    """The MyoPS classes as nested masks, (batch, *spatial) -> (batch, *spatial, 4) float32: background,
    myocardium (>= 1), edema and scar (>= 2), scar (>= 3) (reference myops2020/eval.py)."""
    return torch.stack([labels == 0, labels >= 1, labels >= 2, labels >= 3], dim=-1).float()


def myops2020_segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor,
                                   spacing: Sequence[float]) -> Dict[str, np.ndarray]:
    """Dice, IoU and HD95 of the three grouped classes and the means over them, each (batch,); Dice and IoU
    on the logits' device, HD95 on the host."""
    true_mask = _grouped_masks(labels.long())
    pred_mask = _grouped_masks(logits.argmax(dim=-1))
    dice, iou = torch.stack([dice_score(pred_mask, true_mask), iou_score(pred_mask, true_mask)]).cpu().numpy()
    hd95 = hausdorff_distance_95(pred_mask.bool().cpu().numpy(), true_mask.bool().cpu().numpy(), spacing)
    metrics: Dict[str, np.ndarray] = {}
    for cls in range(1, true_mask.shape[-1]):
        metrics[f"class_{cls}_dice_score"] = dice[:, cls]
        metrics[f"class_{cls}_iou_score"] = iou[:, cls]
        metrics[f"class_{cls}_hausdorff_distance_95"] = hd95[:, cls - 1]
    metrics["mean_dice_score"] = np.nanmean(dice[:, 1:], axis=-1)
    metrics["mean_iou_score"] = np.nanmean(iou[:, 1:], axis=-1)
    metrics["mean_hausdorff_distance_95"] = np.nanmean(hd95, axis=-1)
    return metrics


def load_dataset(config: Config) -> Tuple[MYOPS2020Dataset, MYOPS2020Dataset]:
    """(train, val): the ``max(2, n // 10)`` studies that pandas' ``sample(n=..., random_state=0)`` draws go
    to validation, in drawn order; then the ``max_n_samples`` cap and the ``proportion``."""
    data_dir = Path(config.data.dir).expanduser()
    rows = read_metadata(data_dir / "train_metadata.csv")
    val_ids = pandas_sample(len(rows), max(2, len(rows) // 10), np.random.RandomState(0))
    held = set(val_ids)
    train, val = maybe_subset_dataset(config, [r for i, r in enumerate(rows) if i not in held],
                                      [rows[i] for i in val_ids])
    train_transform, val_transform = get_segmentation_transforms(config)
    return (MYOPS2020Dataset(data_dir / "train", train, train_transform),
            MYOPS2020Dataset(data_dir / "train", val, val_transform))


myops2020_eval_dataloader = partial(segmentation_eval_dataloader, metrics_fn=myops2020_segmentation_metrics)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(config=config, load_dataset=load_dataset, get_model_fn=get_segmentation_model,
                     loss_fn=segmentation_loss_fn, eval_dataloader_fn=myops2020_eval_dataloader,
                     load_pretrained_fn=load_pretrained, out_dir=out_dir, device=device)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("segmentation/myops2020", run, __doc__, argv)


if __name__ == "__main__":
    main()

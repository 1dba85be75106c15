"""Rescan cine segmentation, every frame an item, and the label-free EF from it (port of
cinema_tpu/tasks/segmentation/rescan.py; reference cinema/segmentation/rescan/train.py, ef_eval.py).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.rescan [--config rescan.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvUNetR-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["segmentation/rescan"]``); ``data.dir=...`` names the data,
``model.ckpt_path=...`` pretrained MAE weights (safetensors), ``train.resume_path=...`` a
checkpoint to resume from.

Data: ``data.dir`` holds ``train_metadata.csv`` (``pid`` as ``<group>/<study>``, ``n_slices``,
``n_frames``) and per study ``train/<pid>/sax_t.nii.gz``, the 4-D cine, with its labels
``sax_gt_t.nii.gz``. The first study of each group (pids sorted) is held out for validation.
Every frame of a study is an item, read alone from the cine (``load_nifti_frame``: one gzip
member where the file is frame-indexed) and augmented as the config's ``transform`` section
says; a validation frame is evaluated by sliding window at its own size.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import CineSegmentationDataset, read_metadata
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.metrics import coefficient_of_variance, ejection_fraction
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.segmentation import segmentation_eval_dataloader, segmentation_loss_fn
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train


def load_dataset(config: Config) -> Tuple[CineSegmentationDataset, CineSegmentationDataset]:
    """(train, val) over the studies sorted by pid: the first study of each group (``pid.split("/")[0]``)
    goes to validation; the ``max_n_samples`` cap and the ``proportion`` are drawn over studies, before
    their frames are expanded into items."""
    data_dir = Path(config.data.dir).expanduser()
    rows = sorted(read_metadata(data_dir / "train_metadata.csv"), key=lambda r: str(r["pid"]))
    seen, train, val = set(), [], []
    for row in rows:
        group = str(row["pid"]).split("/")[0]
        (train if group in seen else val).append(row)
        seen.add(group)
    train, val = maybe_subset_dataset(config, train, val)
    train_transform, val_transform = get_segmentation_transforms(config)
    views = config.model.views
    return (CineSegmentationDataset(data_dir / "train", train, views=views, transform=train_transform),
            CineSegmentationDataset(data_dir / "train", val, views=views, transform=val_transform))


def ef_from_volumes(lv_volumes: np.ndarray) -> float:
    """Label-free EF in percent: the largest of a cine's per-frame LV volumes is the EDV, the smallest the
    ESV (reference rescan/ef_eval.py:58-216); NaN where no frame holds LV."""
    edv, esv = np.max(lv_volumes).astype(np.float64), np.min(lv_volumes).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(ejection_fraction(edv, esv))


def test_retest_reproducibility(ef_scan: np.ndarray, ef_rescan: np.ndarray) -> Dict[str, float]:
    """Scan-rescan EF agreement: mean absolute and root mean square difference, coefficient of variance."""
    return {
        "ef_mae": float(np.mean(np.abs(ef_scan - ef_rescan))),
        "ef_rmse": float(np.sqrt(np.mean((ef_scan - ef_rescan) ** 2))),
        "ef_cv": coefficient_of_variance(ef_scan, ef_rescan),
    }


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(config=config, load_dataset=load_dataset, get_model_fn=get_segmentation_model,
                     loss_fn=segmentation_loss_fn, eval_dataloader_fn=segmentation_eval_dataloader,
                     load_pretrained_fn=load_pretrained, out_dir=out_dir, device=device)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("segmentation/rescan", run, __doc__, argv)


if __name__ == "__main__":
    main()

"""ACDC SAX segmentation fine-tuning (port of cinema_tpu/tasks/segmentation/acdc.py;
reference cinema/segmentation/acdc/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.acdc [--config acdc.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvUNetR-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["segmentation/acdc"]``); ``data.dir=...``
names the data, ``model.ckpt_path=...`` pretrained MAE weights (safetensors),
``train.resume_path=...`` a checkpoint to resume from.

Data: ``data.dir`` holds one ``.npz`` per study with ``sax_image`` (x, y, z, 2)
and ``sax_label`` (x, y, z, 2) int8, the ED and ES frames on the last axis, and
``pathology``, the study's class index. Every frame is an item. Two seeded
studies of every pathology are held out for validation, as the JAX package holds
them out; a validation frame is evaluated by sliding window at its own size. NIfTI
input with its metadata table and the augmentation transforms of the JAX package
are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import NpzEDESSegmentationDataset, list_studies
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.segmentation import segmentation_eval_dataloader, segmentation_loss_fn
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train, split_by_class


def load_dataset(config: Config) -> Tuple[NpzEDESSegmentationDataset, NpzEDESSegmentationDataset]:
    paths = list_studies(Path(config.data.dir))
    pathologies = []
    for p in paths:
        with np.load(p) as study:
            pathologies.append(int(study["pathology"]))
    train_ids, val_ids = split_by_class(np.array(pathologies))
    train, val = maybe_subset_dataset(config, [paths[i] for i in train_ids], [paths[i] for i in val_ids])
    size = tuple(config.data.sax.patch_size)
    return NpzEDESSegmentationDataset(train, size, train=True), NpzEDESSegmentationDataset(val, size, train=False)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(
        config=config,
        load_dataset=load_dataset,
        get_model_fn=get_segmentation_model,
        loss_fn=segmentation_loss_fn,
        eval_dataloader_fn=segmentation_eval_dataloader,
        load_pretrained_fn=load_pretrained,
        out_dir=out_dir,
        device=device,
    )


def main(argv: Union[List[str], None] = None) -> None:
    task_main("segmentation/acdc", run, __doc__, argv)


if __name__ == "__main__":
    main()

"""ACDC pathology classification (port of cinema_tpu/tasks/classification/acdc.py;
reference cinema/classification/acdc/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.classification.acdc [--config acdc.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvViT-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["classification/acdc"]``); ``data.dir=...``
names the data, ``model.ckpt_path=...`` pretrained MAE weights (safetensors),
``train.resume_path=...`` a checkpoint to resume from.

Data: ``data.dir`` holds one ``.npz`` per study with ``sax_image`` (x, y, z, 2),
the ED and ES frames as channels, and ``label``, the index of the study's class in
``data.<class_column>``. Two seeded studies of every class are held out for
validation, as the JAX package holds them out. NIfTI input with its metadata
table and the augmentation transforms of the JAX package are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import NpzEDESDataset, list_studies
from cinema_tpu_torch.tasks.classification import (
    classification_eval_dataloader,
    classification_loss_fn,
    get_classification_model,
    view_patch_sizes,
)
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train, split_by_class


def load_dataset(config: Config) -> Tuple[NpzEDESDataset, NpzEDESDataset]:
    paths = list_studies(Path(config.data.dir))
    n_classes = len(config.data[config.data.class_column])
    labels = np.array([int(np.load(p)["label"]) for p in paths])
    if labels.min() < 0 or labels.max() >= n_classes:
        raise ValueError(f"Labels must index the {n_classes} classes of data.{config.data.class_column}.")
    train_ids, val_ids = split_by_class(labels)
    train, val = maybe_subset_dataset(config, [paths[i] for i in train_ids], [paths[i] for i in val_ids],
                                      labels[train_ids], labels[val_ids])
    sizes = view_patch_sizes(config)
    label_fn = lambda study: np.int64(study["label"])  # noqa: E731
    return (NpzEDESDataset(train, list(sizes), sizes, label_fn, train=True),
            NpzEDESDataset(val, list(sizes), sizes, label_fn, train=False))


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None,
        get_model_fn=get_classification_model) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    smoothing = config.train.get("label_smoothing", 0.1)
    return run_train(
        config=config,
        load_dataset=load_dataset,
        get_model_fn=get_model_fn,
        loss_fn=lambda model, batch: classification_loss_fn(model, batch, smoothing),
        eval_dataloader_fn=classification_eval_dataloader,
        load_pretrained_fn=load_pretrained,
        out_dir=out_dir,
        device=device,
    )


def main(argv: Union[List[str], None] = None) -> None:
    task_main("classification/acdc", run, __doc__, argv)


if __name__ == "__main__":
    main()

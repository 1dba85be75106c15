"""What the nine ED/ES fine-tuning tasks share: their datasets and their runs (ports of
cinema_tpu/tasks/{classification,regression,segmentation}/{acdc,mnms,mnms2}.py, which differ in
the names of their data alone).

Data: ``data.dir`` holds what the JAX package's preprocessing writes
(cinema_tpu/data/preprocess/{acdc,mnms,mnms2}.py): per study ``train/<pid>/`` (or ``val/<pid>/``)
with ``<pid>_<view>_{ed,es}.nii.gz`` and the labels ``<pid>_<view>_{ed,es}_gt.nii.gz``, and
the tables ``train_metadata.csv`` (and ``val_metadata.csv``) with the columns ``pid``,
``n_slices``, the class column (``pathology``) and the regression columns (``ef``, ``age``, ...).
ACDC comes as one training table, of which two studies of every class are held out for
validation as pandas draws them; M&Ms and M&Ms2 come split in two.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import (
    EDESClassificationDataset,
    EDESRegressionDataset,
    EDESSegmentationDataset,
    read_metadata,
)
from cinema_tpu_torch.data.datasets import Rows
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.tasks.classification import (
    classification_eval_dataloader,
    classification_loss_fn,
    get_classification_model,
)
from cinema_tpu_torch.tasks.regression import get_regression_model, regression_eval_dataloader, regression_loss_fn
from cinema_tpu_torch.tasks.segmentation import segmentation_eval_dataloader, segmentation_loss_fn
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train, split_by_class

Device = Union[str, torch.device]


def _tables(config: Config, split_column: Optional[str]) -> Tuple[Path, Rows, Path, Rows]:
    """(train directory, train rows, val directory, val rows): with ``split_column`` the studies of
    ``train_metadata.csv`` split two per value of that column (ACDC), otherwise the two tables."""
    data_dir = Path(config.data.dir).expanduser()
    rows = read_metadata(data_dir / "train_metadata.csv")
    if split_column is None:
        return data_dir / "train", rows, data_dir / "val", read_metadata(data_dir / "val_metadata.csv")
    train_ids, val_ids = split_by_class([row[split_column] for row in rows])
    return data_dir / "train", [rows[i] for i in train_ids], data_dir / "train", [rows[i] for i in val_ids]


def classification_datasets(config: Config, split_column: Optional[str] = None):
    """(train, val) ``EDESClassificationDataset``s of the studies whose ``data.class_column`` is one of its
    classes, the ``max_n_samples`` cap drawn per class."""
    class_col = config.data.class_column
    classes = list(config.data[class_col])
    train_dir, train, val_dir, val = _tables(config, split_column)
    train = [r for r in train if r[class_col] in classes]
    val = [r for r in val if r[class_col] in classes]
    train, val = maybe_subset_dataset(config, train, val, [r[class_col] for r in train], [r[class_col] for r in val])
    train_transform, val_transform = get_segmentation_transforms(config)
    views = config.model.views
    return (EDESClassificationDataset(train_dir, train, class_col, classes, views, train_transform),
            EDESClassificationDataset(val_dir, val, class_col, classes, views, val_transform))


def regression_datasets(config: Config, split_column: Optional[str] = None):
    """(train, val) ``EDESRegressionDataset``s of the studies whose ``data.regression_column`` is known,
    z-normalised with the config's ``mean`` and ``std`` of that column."""
    reg_col = config.data.regression_column
    reg_mean, reg_std = float(config.data[reg_col]["mean"]), float(config.data[reg_col]["std"])
    train_dir, train, val_dir, val = _tables(config, split_column)
    train, val = maybe_subset_dataset(config, [r for r in train if r[reg_col] is not None],
                                      [r for r in val if r[reg_col] is not None])
    train_transform, val_transform = get_segmentation_transforms(config)
    views = config.model.views
    return (EDESRegressionDataset(train_dir, train, reg_col, reg_mean, reg_std, views, train_transform),
            EDESRegressionDataset(val_dir, val, reg_col, reg_mean, reg_std, views, val_transform))


def segmentation_datasets(config: Config, split_column: Optional[str] = None,
                          views: Optional[Union[str, Sequence[str]]] = None):
    """(train, val) ``EDESSegmentationDataset``s of ``views`` (default ``config.model.views``)."""
    train_dir, train, val_dir, val = _tables(config, split_column)
    train, val = maybe_subset_dataset(config, train, val)
    train_transform, val_transform = get_segmentation_transforms(config)
    views = config.model.views if views is None else views
    return (EDESSegmentationDataset(train_dir, train, views, train_transform),
            EDESSegmentationDataset(val_dir, val, views, val_transform))


def run_classification(config: Config, load_dataset, device: Device = "cuda", out_dir: Optional[Path] = None,
                       get_model_fn=get_classification_model) -> Path:
    """Fine-tune a classifier on ``load_dataset(config)`` with the smoothed cross entropy; returns the run directory."""
    smoothing = config.train.get("label_smoothing", 0.1)
    return run_train(config=config, load_dataset=load_dataset, get_model_fn=get_model_fn,
                     loss_fn=lambda model, batch: classification_loss_fn(model, batch, smoothing),
                     eval_dataloader_fn=classification_eval_dataloader, load_pretrained_fn=load_pretrained,
                     out_dir=out_dir, device=device)


def run_regression(config: Config, load_dataset, device: Device = "cuda", out_dir: Optional[Path] = None,
                   get_model_fn=get_regression_model) -> Path:
    """Fine-tune a regressor on ``load_dataset(config)`` with the mean squared error; returns the run directory."""
    return run_train(config=config, load_dataset=load_dataset, get_model_fn=get_model_fn, loss_fn=regression_loss_fn,
                     eval_dataloader_fn=regression_eval_dataloader, load_pretrained_fn=load_pretrained,
                     out_dir=out_dir, device=device)


def run_segmentation(config: Config, load_dataset, device: Device = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune ConvUNetR on ``load_dataset(config)``, evaluated by sliding window; returns the run directory."""
    return run_train(config=config, load_dataset=load_dataset, get_model_fn=get_segmentation_model,
                     loss_fn=segmentation_loss_fn, eval_dataloader_fn=segmentation_eval_dataloader,
                     load_pretrained_fn=load_pretrained, out_dir=out_dir, device=device)

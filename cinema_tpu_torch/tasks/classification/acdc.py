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

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import PACKAGED, Config, apply_overrides, from_dict, load_config
from cinema_tpu_torch.convert import load_pretrain_weights, load_safetensors, loaded_freeze_mask
from cinema_tpu_torch.data import NpzEDESDataset, list_studies
from cinema_tpu_torch.tasks.classification import (
    classification_eval_dataloader,
    classification_loss_fn,
    get_classification_model,
    view_patch_sizes,
)
from cinema_tpu_torch.train.loop import run_train


def split_by_class(labels: np.ndarray, n_val_per_class: int = 2, seed: int = 0) -> Tuple[List[int], List[int]]:
    """Indices (train, val): ``n_val_per_class`` seeded studies of every class go to validation."""
    rng = np.random.default_rng(seed)
    val: List[int] = []
    for cls in np.unique(labels):
        members = np.flatnonzero(labels == cls)
        val += sorted(int(i) for i in rng.choice(members, size=min(n_val_per_class, len(members)), replace=False))
    val_set = set(val)
    return [i for i in range(len(labels)) if i not in val_set], sorted(val)


def subset(config: Config, train: List[Path], val: List[Path]) -> Tuple[List[Path], List[Path]]:
    """The ``data.max_n_samples`` cap on both lists and the seeded ``data.proportion`` of
    the training list (reference train.py:49-82)."""
    rng = np.random.default_rng(config.seed)
    cap = config.data.get("max_n_samples", -1)
    if cap > 0:
        train, val = train[:cap], val[:cap]
    proportion = config.data.get("proportion", 1.0)
    if proportion < 1:
        keep = sorted(rng.choice(len(train), size=int(proportion * len(train)), replace=False))
        train = [train[i] for i in keep]
    return train, val


def load_dataset(config: Config) -> Tuple[NpzEDESDataset, NpzEDESDataset]:
    paths = list_studies(Path(config.data.dir))
    n_classes = len(config.data[config.data.class_column])
    labels = np.array([int(np.load(p)["label"]) for p in paths])
    if labels.min() < 0 or labels.max() >= n_classes:
        raise ValueError(f"Labels must index the {n_classes} classes of data.{config.data.class_column}.")
    train_ids, val_ids = split_by_class(labels)
    train, val = subset(config, [paths[i] for i in train_ids], [paths[i] for i in val_ids])
    sizes = view_patch_sizes(config)
    label_fn = lambda study: np.int64(study["label"])  # noqa: E731
    return (NpzEDESDataset(train, list(sizes), sizes, label_fn, train=True),
            NpzEDESDataset(val, list(sizes), sizes, label_fn, train=False))


def load_pretrained(model: nn.Module, config: Config) -> Dict[str, bool]:
    """MAE -> ConvViT transfer from a safetensors checkpoint; returns the freeze mask."""
    state_dict = load_safetensors(Path(config.model.ckpt_path).expanduser())
    views = [config.model.views] if isinstance(config.model.views, str) else list(config.model.views)
    return loaded_freeze_mask(model, load_pretrain_weights(model, views, state_dict, keep_fusion=False))


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


def task_main(packaged: str, run_fn, doc: str, argv: Union[List[str], None] = None) -> None:
    """The command line of a fine-tuning task: ``--config``, ``--device`` and key=value overrides."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--config", type=Path, help=f"YAML config (default: the packaged {packaged} config)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides, e.g. data.dir=studies")
    args = parser.parse_args(argv)
    config = load_config(args.config) if args.config else from_dict(PACKAGED[packaged])
    run_fn(apply_overrides(config, args.overrides), device=args.device)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("classification/acdc", run, __doc__, argv)


if __name__ == "__main__":
    main()

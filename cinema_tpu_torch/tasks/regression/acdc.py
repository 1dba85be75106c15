"""ACDC ejection-fraction / BMI regression (port of cinema_tpu/tasks/regression/acdc.py;
reference cinema/regression/acdc/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.regression.acdc [--config acdc.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvViT-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["regression/acdc"]``); ``data.dir=...`` names
the data, ``model.ckpt_path=...`` pretrained MAE weights (safetensors),
``train.resume_path=...`` a checkpoint to resume from.

Data: ``data.dir`` holds one ``.npz`` per study with ``sax_image`` (x, y, z, 2),
the ED and ES frames as channels, the target under the name of
``data.regression_column`` (``ef``, ``bmi``) and ``label``, the study's pathology
class index. The target is z-normalised with ``data.<column>.mean`` and ``.std``;
studies whose target is NaN are left out; two seeded studies of every pathology
are held out for validation, as the JAX package holds them out. NIfTI input with
its metadata table and the augmentation transforms of the JAX package are not
ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.convert import load_pretrained
from cinema_tpu_torch.data import NpzEDESDataset, list_studies
from cinema_tpu_torch.tasks.classification import view_patch_sizes
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.regression import get_regression_model, regression_eval_dataloader, regression_loss_fn
from cinema_tpu_torch.train.loop import maybe_subset_dataset, run_train, split_by_class


def load_dataset(config: Config) -> Tuple[NpzEDESDataset, NpzEDESDataset]:
    paths = list_studies(Path(config.data.dir))
    col = config.data.regression_column
    mean, std = float(config.data[col]["mean"]), float(config.data[col]["std"])
    labels, targets = [], []
    for p in paths:
        with np.load(p) as study:
            labels.append(int(study["label"]))
            targets.append(float(study[col]))
    train_ids, val_ids = split_by_class(np.array(labels))
    known = ~np.isnan(np.array(targets))
    train, val = maybe_subset_dataset(config, [paths[i] for i in train_ids if known[i]],
                                      [paths[i] for i in val_ids if known[i]])
    sizes = view_patch_sizes(config)
    label_fn = lambda study: np.float32((float(study[col]) - mean) / std)  # noqa: E731
    return (NpzEDESDataset(train, list(sizes), sizes, label_fn, train=True),
            NpzEDESDataset(val, list(sizes), sizes, label_fn, train=False))


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None,
        get_model_fn=get_regression_model) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_train(
        config=config,
        load_dataset=load_dataset,
        get_model_fn=get_model_fn,
        loss_fn=regression_loss_fn,
        eval_dataloader_fn=regression_eval_dataloader,
        load_pretrained_fn=load_pretrained,
        out_dir=out_dir,
        device=device,
    )


def main(argv: Union[List[str], None] = None) -> None:
    task_main("regression/acdc", run, __doc__, argv)


if __name__ == "__main__":
    main()

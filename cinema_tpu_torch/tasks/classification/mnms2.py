"""M&Ms2 pathology classification (port of cinema_tpu/tasks/classification/mnms2.py;
reference cinema/classification/mnms2/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.classification.mnms2 [--config mnms2.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvViT-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["classification/mnms2"]``); ``data.dir=...`` names the data,
``model.ckpt_path=...`` pretrained MAE weights (safetensors), ``train.resume_path=...`` a
checkpoint to resume from.

Data: processed NIfTI studies and their metadata tables (cinema_tpu_torch/tasks/edes.py):
``data.dir`` holds ``train_metadata.csv`` with ``train/<pid>/`` and ``val_metadata.csv``
with ``val/<pid>/``. Training items are augmented as the config's ``transform`` section
says. The label is the index of the study's ``data.class_column`` in the config's classes;
studies of other classes are left out.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.tasks.classification import get_classification_model
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.edes import classification_datasets, run_classification


def load_dataset(config: Config):
    return classification_datasets(config)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None,
        get_model_fn=get_classification_model) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_classification(config, load_dataset, device, out_dir, get_model_fn)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("classification/mnms2", run, __doc__, argv)


if __name__ == "__main__":
    main()

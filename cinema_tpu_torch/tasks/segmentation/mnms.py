"""M&Ms segmentation fine-tuning (port of cinema_tpu/tasks/segmentation/mnms.py;
reference cinema/segmentation/mnms/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.mnms [--config mnms.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvUNetR-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["segmentation/mnms"]``); ``data.dir=...`` names the data,
``model.ckpt_path=...`` pretrained MAE weights (safetensors), ``train.resume_path=...`` a
checkpoint to resume from.

Data: processed NIfTI studies and their metadata tables (cinema_tpu_torch/tasks/edes.py):
``data.dir`` holds ``train_metadata.csv`` with ``train/<pid>/`` and ``val_metadata.csv``
with ``val/<pid>/``. Training items are augmented as the config's ``transform`` section
says. Every ED and ES frame is an item with its label; a validation frame is evaluated by
sliding window at its own size.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.edes import run_segmentation, segmentation_datasets


def load_dataset(config: Config):
    return segmentation_datasets(config)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_segmentation(config, load_dataset, device, out_dir)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("segmentation/mnms", run, __doc__, argv)


if __name__ == "__main__":
    main()

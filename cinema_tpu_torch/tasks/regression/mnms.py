"""M&Ms ejection-fraction / age regression (port of cinema_tpu/tasks/regression/mnms.py;
reference cinema/regression/mnms/train.py).

Usage:
    python -m cinema_tpu_torch.tasks.regression.mnms [--config mnms.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged ConvViT-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["regression/mnms"]``); ``data.dir=...`` names the data,
``model.ckpt_path=...`` pretrained MAE weights (safetensors), ``train.resume_path=...`` a
checkpoint to resume from.

Data: processed NIfTI studies and their metadata tables (cinema_tpu_torch/tasks/edes.py):
``data.dir`` holds ``train_metadata.csv`` with ``train/<pid>/`` and ``val_metadata.csv``
with ``val/<pid>/``. Training items are augmented as the config's ``transform`` section
says. The label is ``data.regression_column`` z-normalised with ``data.<column>.mean`` and
``.std``; studies where it is empty are left out.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.tasks.edes import regression_datasets, run_regression
from cinema_tpu_torch.tasks.regression import get_regression_model


def load_dataset(config: Config):
    return regression_datasets(config)


def run(config: Config, device: Union[str, torch.device] = "cuda", out_dir: Optional[Path] = None,
        get_model_fn=get_regression_model) -> Path:
    """Fine-tune as ``config`` says, on ``device``; returns the run directory."""
    return run_regression(config, load_dataset, device, out_dir, get_model_fn)


def main(argv: Union[List[str], None] = None) -> None:
    task_main("regression/mnms", run, __doc__, argv)


if __name__ == "__main__":
    main()

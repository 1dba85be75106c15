"""Label-free EF on the Kaggle Data Science Bowl cines (port of cinema_tpu/tasks/segmentation/kaggle.py;
reference cinema/segmentation/kaggle/eval.py).

Every frame of a cine is segmented, the largest and the smallest LV volume of its frames are
the EDV and the ESV, and the EF from them is held against the dataset's volumes. There is no
training: ``evaluate_kaggle`` is reached through ``python -m cinema_tpu_torch.tasks.evaluate
--folder_path <run> --data kaggle``, with a model fine-tuned on another dataset.

Data: ``data.dir`` holds ``<split>_metadata.csv`` (``pid``, an integer, ``n_slices``,
``n_frames``, ``diastole_volume`` and ``systole_volume`` in ml) and per study
``<split>/<pid>/<pid>_<view>_t.nii.gz``, the cine (x, y, z, t).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.constants import LV_LABEL
from cinema_tpu_torch.data import BatchLoader, KaggleVideoDataset, read_metadata
from cinema_tpu_torch.data.transforms import Compose, ScaleIntensityd, SpatialPadd
from cinema_tpu_torch.metrics import ejection_fraction, get_ef_region
from cinema_tpu_torch.train.loop import pandas_sample

MAX_N_FRAMES = 30  # reference kaggle/eval.py
VIDEO_CHUNK = 8  # frames per forward


@torch.no_grad()
def video_lv_volumes(model: nn.Module, video: torch.Tensor, spacing: Sequence[float], n_frames: int) -> np.ndarray:
    """Per-frame LV volumes in ml of a cine, (n_frames,) float64.

    ``video`` (t, *spatial, 1), on the model's device, goes through the model in chunks of VIDEO_CHUNK
    frames as ``sax``, its tail filled with its first frames as the JAX package fills it; each voxel is
    labelled by the argmax of its logits, and the voxels labelled LV_LABEL are counted. The first
    ``n_frames`` frames' volumes are returned.
    """
    n_pad = (-len(video)) % VIDEO_CHUNK
    if n_pad:
        video = torch.cat([video, video[:n_pad]])
    counts = torch.cat([(model({"sax": video[i : i + VIDEO_CHUNK]})["sax"].argmax(dim=-1) == LV_LABEL).flatten(1).sum(1)
                        for i in range(0, len(video), VIDEO_CHUNK)])
    voxel_ml = float(np.prod(np.asarray(spacing))) / 1000.0
    return (counts.cpu().numpy() * voxel_ml)[:n_frames]


@torch.no_grad()
def evaluate_kaggle(model: nn.Module, config: Config, split: str = "validate",
                    max_n_samples: int = -1) -> Dict[str, float]:
    """EF mean absolute error, RMSE and EF-region accuracy over the cines of ``split`` (at most
    ``max_n_samples``, those that pandas' ``sample(n=..., random_state=0)`` draws), and their count.

    A cine's first MAX_N_FRAMES frames are min-max scaled together and end-padded to the patch size;
    each frame is one forward of the model at that size, without a sliding window, as in the JAX package.
    The model is left in eval mode.
    """
    model.eval()
    device = next(model.parameters()).device
    data_dir = Path(config.data.dir).expanduser()
    view = config.model.views
    if not isinstance(view, str):
        raise TypeError("Only support one view for evaluation.")
    rows = read_metadata(data_dir / f"{split}_metadata.csv")
    if max_n_samples > 0:
        rows = [rows[i] for i in pandas_sample(len(rows), min(max_n_samples, len(rows)), np.random.RandomState(0))]
    spacing = tuple(config.data.sax.spacing)
    key = f"{view}_image"
    transform = Compose([ScaleIntensityd(key), SpatialPadd(key, tuple(config.data.sax.patch_size))])
    dataset = KaggleVideoDataset(data_dir / split, rows, view=view, max_n_frames=MAX_N_FRAMES, transform=transform)
    pred_ef, true_ef = [], []
    with BatchLoader(dataset, 1, shuffle=False, drop_last=False, n_workers=config.train.get("n_workers", 4)) as loader:
        for batch in loader.epoch(0):
            n_frames = min(int(batch["n_frames"][0]), MAX_N_FRAMES)
            volumes = video_lv_volumes(model, torch.from_numpy(batch[key][0]).to(device), spacing, n_frames)
            with np.errstate(divide="ignore", invalid="ignore"):
                pred_ef.append(float(ejection_fraction(volumes.max(), max(volumes.min(), 1e-6))))
            true_ef.append(float(batch["ef"][0]))
    pred, true = np.asarray(pred_ef), np.asarray(true_ef)
    err = pred - true
    return {
        "ef_mae": float(np.mean(np.abs(err))),
        "ef_rmse": float(np.sqrt(np.mean(err**2))),
        "ef_region_accuracy": float(np.mean([get_ef_region(p) == get_ef_region(t) for p, t in zip(pred, true)])),
        "n_samples": float(len(pred)),
    }

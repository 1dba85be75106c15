"""Label-free EF test-retest reproducibility on paired Rescan acquisitions (port of
cinema_tpu/tasks/segmentation/rescan_ef_eval.py; reference cinema/segmentation/rescan/ef_eval.py:58-216).

Usage:
    python -m cinema_tpu_torch.tasks.segmentation.rescan_ef_eval --folder_path <run> [--split test_retest_100] [--device cuda]

The run folder's model (``tasks.evaluate.load_run``, bfloat16) segments every frame of each
acquisition's SAX cine; the largest and the smallest per-frame LV volume give the EF. The EFs of
each subject's acquisitions are compared (MAE, RMSE, coefficient of variance, EF-region
agreement) and, where the table has ``ef``, held against it. ``ef_metrics.csv`` (one row per
acquisition) and ``mean_metrics.csv`` go to ``<run>/rescan_<split>_ef_eval/``.

Data: ``data.dir`` holds ``<split>_metadata.csv`` with one row per acquisition (``pid``, and
optionally ``subject``, ``acq`` and ``ef``) and ``<split>/<pid>/sax_t.nii.gz``. A pid
``scan_<i>_<A|B>`` names subject ``scan_<i>`` and acquisition ``A`` or ``B``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.data import load_nifti, read_metadata
from cinema_tpu_torch.data.datasets import write_table
from cinema_tpu_torch.data.transforms import scale_intensity, spatial_pad
from cinema_tpu_torch.metrics import coefficient_of_variance, get_ef_region
from cinema_tpu_torch.tasks.segmentation.kaggle import video_lv_volumes
from cinema_tpu_torch.tasks.segmentation.rescan import ef_from_volumes


def _subject_acq(pid: str) -> Tuple[str, str]:
    """``scan_00_A`` -> (``scan_00``, ``A``); a pid without such a suffix falls back to its path parts."""
    if "_" in pid:
        subject, acq = pid.rsplit("_", 1)
        if len(acq) <= 2:
            return subject, acq
    parts = pid.split("/")
    return parts[0], parts[-1]


def _nan(x: Any) -> bool:
    return x is None or (isinstance(x, float) and np.isnan(x))


def evaluate_pair_reproducibility(rows: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """EF agreement between the first two acquisitions of each subject, as pandas'
    ``pivot_table(index="subject", columns="acq", values="ef").dropna()`` pairs them: the mean EF of each
    (subject, acquisition) over its rows with an EF, acquisitions and subjects sorted, the subjects that lack
    one of the acquisitions dropped. Adds the MAE and RMSE against ``label_ef`` where a row has one."""
    sums: Dict[Tuple[Any, Any], List[float]] = {}
    for row in rows:
        if not _nan(row["ef"]):
            sums.setdefault((row["subject"], row["acq"]), []).append(float(row["ef"]))
    means = {key: float(np.sum(v) / len(v)) for key, v in sums.items()}
    acqs = sorted({acq for _, acq in means})
    subjects = [s for s in sorted({s for s, _ in means}) if all((s, acq) in means for acq in acqs)]
    a = np.array([means[(s, acqs[0])] for s in subjects], np.float64)
    b = np.array([means[(s, acqs[1])] for s in subjects], np.float64)
    out = {
        "n_pairs": int(len(a)),
        "ef_mae": float(np.mean(np.abs(a - b))),
        "ef_rmse": float(np.sqrt(np.mean((a - b) ** 2))),
        "ef_cv": coefficient_of_variance(a, b),
        "ef_region_agreement": float(np.mean([get_ef_region(x) == get_ef_region(y) for x, y in zip(a, b)])),
    }
    labelled = [row for row in rows if not _nan(row.get("label_ef"))]
    if labelled:  # agreement with the human labels (reference ef_eval.py:148-170)
        err = np.array([row["ef"] for row in labelled], np.float64) - np.array([row["label_ef"] for row in labelled])
        out["ef_label_mae"] = float(np.mean(np.abs(err)))
        out["ef_label_rmse"] = float(np.sqrt(np.mean(err**2)))
    return out


@torch.no_grad()
def rescan_ef_eval(config: Config, model: nn.Module, split: str, out_dir: Path) -> Dict[str, float]:
    """Segment every frame of every acquisition of ``split`` (min-max scaled, end-padded to the patch size,
    one forward per chunk of frames), derive each EF, write ``ef_metrics.csv`` and ``mean_metrics.csv`` to
    ``out_dir`` and return the pair summary. The model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    data_dir = Path(config.data.dir).expanduser()
    patch_size = tuple(config.data.sax.patch_size)
    spacing = tuple(config.data.sax.spacing)
    rows: List[Dict[str, Any]] = []
    for row in read_metadata(data_dir / f"{split}_metadata.csv"):
        pid = str(row["pid"])
        video, _ = load_nifti(data_dir / split / pid / "sax_t.nii.gz")  # (x, y, z, t)
        n_frames = video.shape[-1]
        frames = np.stack([spatial_pad(scale_intensity(video[..., t][..., None].astype(np.float32)), patch_size)
                           for t in range(n_frames)])
        volumes = video_lv_volumes(model, torch.from_numpy(frames).to(device), spacing, n_frames)
        subject, acq = _subject_acq(pid)
        rows.append({
            "pid": pid, "subject": row.get("subject", subject), "acq": row.get("acq", acq),
            "ef": ef_from_volumes(volumes), "edv": float(volumes.max()), "esv": float(volumes.min()),
            "label_ef": float(row["ef"]) if row.get("ef") is not None else float("nan"),
        })
    out_dir.mkdir(parents=True, exist_ok=True)
    write_table(out_dir / "ef_metrics.csv", rows)
    summary = evaluate_pair_reproducibility(rows)
    write_table(out_dir / "mean_metrics.csv", [summary])
    print(f"EF reproducibility: {summary}", flush=True)
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Rescan test-retest EF reproducibility.")
    parser.add_argument("--folder_path", type=Path, required=True, help="run folder (run.json or config.yaml, "
                                                                        "and safetensors)")
    parser.add_argument("--split", type=str, default="test_retest_100")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cinema_tpu_torch.tasks.evaluate import load_run

    config, model = load_run(args.folder_path, dtype=torch.bfloat16, device=args.device)
    rescan_ef_eval(config, model, args.split, args.folder_path / f"rescan_{args.split}_ef_eval")


if __name__ == "__main__":
    main()

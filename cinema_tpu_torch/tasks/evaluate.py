"""Evaluation of a run folder on a dataset split (port of cinema_tpu/tasks/evaluate.py, the
``cinema_eval`` dispatcher; reference cinema/eval.py and segmentation/eval.py).

Usage:
    python -m cinema_tpu_torch.tasks.evaluate --folder_path <run> [--split test] [--data <name>] [--device cuda]

:func:`load_run` rebuilds a run folder's model: the newest ``*.safetensors`` of the folder
and its config, from ``config.yaml`` (written by the JAX package's and the port's ``run_train``) or,
in a folder of an older port, from the nested config of ``run.json``. The model runs in float32
unless the caller asks for another dtype, as in the JAX package, and :func:`main` evaluates with
TF32 off (:func:`float32_precision`).
``--data`` (default: the config's ``data.name``) picks the route:

- segmentation: ``acdc``, ``mnms``, ``mnms2`` (ED/ES frames: ``metrics.csv``,
  ``mean_metrics.csv``, ``ef_metrics.csv``); ``emidec``, ``myops2020`` (one volume per study,
  grouped-class metrics); ``kaggle`` (label-free EF); ``rescan`` (per-frame metrics, or with
  ``--split test_retest_100`` the EF reproducibility); ``landmark`` (heatmaps);
- classification and regression on ``acdc``, ``mnms``, ``mnms2``; regression on ``landmark``
  (coordinates).

Every table goes to ``<run>/<data>_eval/``, written as the JAX package's pandas writes it.
The ``main_<data>_<task>`` functions are that dispatcher with ``--data`` fixed and the
folder's task checked.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config, from_dict, load_config
from cinema_tpu_torch.constants import LV_LABEL
from cinema_tpu_torch.convert import drop_frozen_pos_embeds, load_safetensors
from cinema_tpu_torch.data import (
    BatchLoader,
    CineSegmentationDataset,
    EDESClassificationDataset,
    EDESRegressionDataset,
    EDESSegmentationDataset,
    EMIDECDataset,
    LandmarkDetectionDataset,
    LandmarkRegressionDataset,
    MYOPS2020Dataset,
    read_metadata,
    to_device,
)
from cinema_tpu_torch.data.datasets import column_means, write_table
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.factory import expected_frozen_pos_embeds, get_segmentation_model, resolve_device
from cinema_tpu_torch.metrics import ejection_fraction, get_ef_region, segmentation_metrics
from cinema_tpu_torch.tasks.classification import classification_eval_dataloader, get_classification_model
from cinema_tpu_torch.tasks.regression import regression_eval_dataloader
from cinema_tpu_torch.tasks.regression.landmark import landmark_regression_eval_dataloader
from cinema_tpu_torch.tasks.segmentation import MetricsFn, patch_and_spacing_dicts, segmentation_eval_batch
from cinema_tpu_torch.tasks.segmentation.emidec import emidec_segmentation_metrics
from cinema_tpu_torch.tasks.segmentation.kaggle import evaluate_kaggle
from cinema_tpu_torch.tasks.segmentation.landmark import landmark_eval_dataloader
from cinema_tpu_torch.tasks.segmentation.myops2020 import myops2020_segmentation_metrics
from cinema_tpu_torch.tasks.segmentation.rescan_ef_eval import rescan_ef_eval

Device = Union[str, torch.device]
Row = Dict[str, Any]


@contextlib.contextmanager
def float32_precision():
    """TF32 off for cuBLAS and cuDNN inside the block; the caller's settings are restored after it."""
    # torch runs float32 convolutions in TF32 by default (~3 decimal digits); the evaluation is float32
    matmul, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn


def run_config(folder: Path) -> Config:
    """A run folder's config: its ``config.yaml`` (what the JAX package's and the port's ``run_train`` write),
    or else the nested ``config`` of the ``run.json`` that the port wrote before it wrote ``config.yaml``.
    A folder with neither, or with only a flat ``run.json`` (whose keys are joined with ``_`` and cannot be
    split back), raises FileNotFoundError."""
    folder = Path(folder)
    if (folder / "config.yaml").exists():
        return load_config(folder / "config.yaml")
    if not (folder / "run.json").exists():
        raise FileNotFoundError(f"{folder} holds neither config.yaml nor run.json: not a run folder.")
    config = json.loads((folder / "run.json").read_text()).get("config")
    flat = isinstance(config, dict) and not any(isinstance(v, dict) for v in config.values()) \
        and any("_" in k for k in config)  # model_name, data_dir, ...
    if not isinstance(config, dict) or flat:
        raise FileNotFoundError(f"{folder} has no config.yaml, and its run.json holds a flattened config, which "
                                "does not give the nested one back: restore the run's config.yaml.")
    return from_dict(config)


def load_run(folder: Path, dtype: torch.dtype = torch.float32, device: Device = "cuda") -> Tuple[Config, nn.Module]:
    """(config, model in eval mode on ``device``) of a run folder, the weights those of its newest
    ``*.safetensors`` by modification time."""
    folder = Path(folder)
    config = run_config(folder)
    checkpoints = sorted(folder.glob("*.safetensors"), key=lambda p: p.stat().st_mtime)
    if not checkpoints:
        raise FileNotFoundError(f"No safetensors checkpoints in {folder}.")
    print(f"Using checkpoint: {checkpoints[-1]}", flush=True)
    device = resolve_device(device)
    build = get_segmentation_model if config.task == "segmentation" else get_classification_model
    model = build(config, dtype=dtype, device=device)
    state = drop_frozen_pos_embeds(load_safetensors(checkpoints[-1]), expected_frozen_pos_embeds(model))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return config, model.eval()


def _view(config: Config) -> str:
    return config.model.views if isinstance(config.model.views, str) else config.model.views[0]


def _n_workers(config: Config) -> int:
    return config.train.get("n_workers", 4)


def _write_means(out_dir: Path, rows: List[Row], metrics: Dict[str, float]) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    if rows:
        write_table(out_dir / "metrics.csv", rows)
    write_table(out_dir / "mean_metrics.csv", [metrics])


def ef_metrics_from_edes(rows: Sequence[Row], lv_class: int = LV_LABEL) -> List[Row]:
    """Per study the true and predicted EF from the LV volumes of its ED and ES rows (``pid``, ``is_ed``,
    ``class_{lv_class}_{true,pred}_volume``), the error and the EF regions (reference
    segmentation/eval.py:28-118); studies in the order of their ED rows, those without an ES row left out."""
    es = {row["pid"]: row for row in rows if not row["is_ed"]}
    out = []
    for ed in (row for row in rows if row["is_ed"] and row["pid"] in es):
        out_row: Row = {"pid": ed["pid"]}
        for kind in ("true", "pred"):
            key = f"class_{lv_class}_{kind}_volume"
            with np.errstate(divide="ignore", invalid="ignore"):
                out_row[f"{kind}_ef"] = float(ejection_fraction(np.float64(ed[key]), np.float64(es[ed["pid"]][key])))
        out_row["ef_error"] = out_row["pred_ef"] - out_row["true_ef"]
        out_row["true_region"] = get_ef_region(out_row["true_ef"])
        out_row["pred_region"] = get_ef_region(out_row["pred_ef"])
        out.append(out_row)
    return out


def _eval_batch(model: nn.Module, batch: Dict[str, Any], config: Config, metrics_fn: MetricsFn,
                per_sample: bool = False):
    patch_size_dict, spacing_dict = patch_and_spacing_dicts(config)
    device = next(model.parameters()).device
    tensors = to_device({k: v for k, v in batch.items() if k.endswith(("_image", "_label"))}, device)
    return segmentation_eval_batch(model, {**batch, **tensors}, patch_size_dict, spacing_dict, metrics_fn,
                                   z_bucket=config.get("eval", {}).get("z_bucket", 4), per_sample=per_sample)[1]


@torch.no_grad()
def edes_seg_eval(config: Config, split: str, out_dir: Path, model: nn.Module,
                  metrics_fn: MetricsFn = segmentation_metrics) -> None:
    """Each ED and ES frame's metrics (``metrics.csv``), their means (``mean_metrics.csv``) and each study's
    EF from its LV volumes (``ef_metrics.csv``) over ``split``."""
    model.eval()
    data_dir = Path(config.data.dir).expanduser()
    _, val_transform = get_segmentation_transforms(config)
    dataset = EDESSegmentationDataset(data_dir / split, read_metadata(data_dir / f"{split}_metadata.csv"),
                                      views=config.model.views, transform=val_transform)
    rows: List[Row] = []
    with BatchLoader(dataset, 1, shuffle=False, drop_last=False, n_workers=_n_workers(config)) as loader:
        for batch in loader.epoch(0):
            metrics = _eval_batch(model, batch, config, metrics_fn)
            rows.append({**metrics, "pid": batch["pid"][0], "is_ed": bool(np.asarray(batch["is_ed"]).reshape(-1)[0])})
    _write_means(out_dir, rows, column_means(rows, ("pid", "is_ed")))
    view = _view(config)
    # the "{view}_" prefix exactly: the unprefixed mean-metric names must never match
    vol_cols = [c for c in dict.fromkeys(k for r in rows for k in r) if "volume" in c and c.startswith(f"{view}_")]
    if vol_cols:
        slim = [{"pid": r["pid"], "is_ed": r["is_ed"], **{c[len(view) + 1 :]: r[c] for c in vol_cols}} for r in rows]
        write_table(out_dir / "ef_metrics.csv", ef_metrics_from_edes(slim))
    print(f"Wrote metrics to {out_dir}.", flush=True)


@torch.no_grad()
def volume_seg_eval(config: Config, split: str, out_dir: Path, model: nn.Module, dataset_cls,
                    metrics_fn: MetricsFn) -> None:
    """One volume per study (EMIDEC, MyoPS2020: no ED/ES pairing, so no EF): each study's metrics and their
    means (reference segmentation/{emidec,myops2020}/eval.py)."""
    model.eval()
    data_dir = Path(config.data.dir).expanduser()
    _, val_transform = get_segmentation_transforms(config)
    dataset = dataset_cls(data_dir / split, read_metadata(data_dir / f"{split}_metadata.csv"), transform=val_transform)
    rows: List[Row] = []
    with BatchLoader(dataset, 1, shuffle=False, drop_last=False, n_workers=_n_workers(config)) as loader:
        for batch in loader.epoch(0):
            rows.append({**_eval_batch(model, batch, config, metrics_fn), "pid": batch["pid"][0]})
    _write_means(out_dir, rows, column_means(rows, ("pid",)))
    print(f"Wrote metrics to {out_dir}.", flush=True)


@torch.no_grad()
def rescan_seg_eval(config: Config, split: str, out_dir: Path, model: nn.Module) -> None:
    """Each frame's metrics over the cines of ``split`` (reference segmentation/rescan/eval.py), and their means.

    A study's frames go through the sliding window together, ``eval.frames_per_forward`` (default 8) at a
    time; the last chunk is filled by repeating the study's frames from its start and the metrics of the
    repeats are dropped. Worker threads read the next two chunks while one is evaluated.
    """
    model.eval()
    data_dir = Path(config.data.dir).expanduser()
    _, val_transform = get_segmentation_transforms(config)
    dataset = CineSegmentationDataset(data_dir / split, read_metadata(data_dir / f"{split}_metadata.csv"),
                                      views=config.model.views, transform=val_transform)
    chunk = int(config.get("eval", {}).get("frames_per_forward", 8))
    by_pid: Dict[str, List[int]] = {}
    for index, (r, _) in enumerate(dataset.index_map):
        by_pid.setdefault(str(dataset.rows[r]["pid"]), []).append(index)
    chunks: List[Tuple[str, List[int], int]] = []
    for pid, indices in by_pid.items():
        for start in range(0, len(indices), chunk):
            ids = indices[start : start + chunk]
            n_real = len(ids)
            ids += [indices[(start + i) % len(indices)] for i in range(n_real, chunk)]
            chunks.append((pid, ids, n_real))

    rows: List[Row] = []
    with ThreadPoolExecutor(max(1, _n_workers(config))) as pool:
        pending: deque = deque()

        def submit(c: Tuple[str, List[int], int]) -> None:
            pending.append((c, [pool.submit(dataset.load, i) for i in c[1]]))

        it = iter(chunks)
        for c in list(islice(it, 2)):
            submit(c)
        while pending:
            (pid, _, n_real), futures = pending.popleft()
            samples = [f.result() for f in futures]
            if (nxt := next(it, None)) is not None:
                submit(nxt)
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0] if isinstance(samples[0][k], np.ndarray)}
            frame_metrics = _eval_batch(model, batch, config, segmentation_metrics, per_sample=True)
            rows += [{**frame_metrics[i], "pid": pid, "frame": int(samples[i]["frame"])} for i in range(n_real)]
    _write_means(out_dir, rows, column_means(rows, ("pid", "frame")))
    print(f"Wrote metrics to {out_dir}.", flush=True)


def _loader_means(out_dir: Path, dataset, eval_fn: Callable, model: nn.Module, config: Config) -> Dict[str, float]:
    with BatchLoader(dataset, 1, shuffle=False, drop_last=False, n_workers=_n_workers(config)) as loader:
        metrics = eval_fn(model, loader, config)
    _write_means(out_dir, [], metrics)
    return metrics


def landmark_seg_eval(config: Config, split: str, out_dir: Path, model: nn.Module) -> None:
    """The landmark heatmaps' mean errors over ``split`` (reference eval.py:159-168)."""
    data_dir = Path(config.data.dir).expanduser()
    dataset = LandmarkDetectionDataset(data_dir, read_metadata(data_dir / f"{split}_metadata.csv"), _view(config))
    print(f"Landmark heatmap eval: {_loader_means(out_dir, dataset, landmark_eval_dataloader, model, config)}",
          flush=True)


def landmark_reg_eval(config: Config, split: str, out_dir: Path, model: nn.Module) -> None:
    """The landmark coordinates' mean errors over ``split`` (reference eval.py:100-113)."""
    data_dir = Path(config.data.dir).expanduser()
    dataset = LandmarkRegressionDataset(data_dir, read_metadata(data_dir / f"{split}_metadata.csv"), _view(config))
    print(f"Landmark regression eval: "
          f"{_loader_means(out_dir, dataset, landmark_regression_eval_dataloader, model, config)}", flush=True)


def _segmentation(config: Config, data: str, split: str, out_dir: Path, model: nn.Module) -> None:
    if data in ("acdc", "mnms", "mnms2"):
        edes_seg_eval(config, split, out_dir, model)
    elif data == "emidec":
        volume_seg_eval(config, split, out_dir, model, EMIDECDataset, emidec_segmentation_metrics)
    elif data == "myops2020":
        volume_seg_eval(config, split, out_dir, model, MYOPS2020Dataset, myops2020_segmentation_metrics)
    elif data == "kaggle":
        _write_means(out_dir, [], evaluate_kaggle(model, config, split=split))
    elif data == "rescan":
        if split == "test_retest_100":
            rescan_ef_eval(config, model, split, out_dir)
        else:
            rescan_seg_eval(config, split, out_dir, model)
    elif data == "landmark":
        landmark_seg_eval(config, split, out_dir, model)
    else:
        raise ValueError(f"Unknown dataset: {data}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Evaluate a run folder on a dataset split.")
    parser.add_argument("--folder_path", type=Path, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--data", type=str, default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    with float32_precision():
        _evaluate(args)


def _evaluate(args: argparse.Namespace) -> None:
    config, model = load_run(args.folder_path, device=args.device)
    data = args.data or config.data.name
    out_dir = args.folder_path / f"{data}_eval"
    if config.task == "segmentation":
        _segmentation(config, data, args.split, out_dir, model)
        return
    if config.task not in ("classification", "regression"):
        raise ValueError(f"Unknown evaluation task: {config.task}")
    if config.task == "regression" and data == "landmark":
        landmark_reg_eval(config, args.split, out_dir, model)
        return
    data_dir = Path(config.data.dir).expanduser()
    rows = read_metadata(data_dir / f"{args.split}_metadata.csv")
    _, val_transform = get_segmentation_transforms(config)
    if config.task == "classification":
        class_col = config.data.class_column
        classes = list(config.data[class_col])
        dataset = EDESClassificationDataset(data_dir / args.split, [r for r in rows if r[class_col] in classes],
                                            class_col, classes, config.model.views, val_transform)
        _loader_means(out_dir, dataset, classification_eval_dataloader, model, config)
    else:
        reg_col = config.data.regression_column
        dataset = EDESRegressionDataset(data_dir / args.split, [r for r in rows if r[reg_col] is not None], reg_col,
                                        float(config.data[reg_col]["mean"]), float(config.data[reg_col]["std"]),
                                        config.model.views, val_transform)
        _loader_means(out_dir, dataset, regression_eval_dataloader, model, config)


def _make_dataset_eval_main(data: str, task: str) -> Callable[[Optional[List[str]]], None]:
    """:func:`main` for one dataset and task (the reference's ``<data>_<task>_eval`` scripts,
    pyproject.toml:58-106): ``--data`` fixed, the run folder's task checked."""

    def _main(argv: Optional[List[str]] = None) -> None:
        parser = argparse.ArgumentParser(description=f"Evaluate a {data} {task} run folder.")
        parser.add_argument("--folder_path", type=Path, required=True)
        parser.add_argument("--split", type=str, default="test")
        parser.add_argument("--device", default="cuda")
        args = parser.parse_args(argv)
        found = run_config(args.folder_path).task
        if found != task:
            raise ValueError(f"{data}_{task} eval called on a '{found}' run folder ({args.folder_path}); use the "
                             f"matching main_<data>_{{seg,clf,reg}}.")
        main(["--folder_path", str(args.folder_path), "--split", args.split, "--data", data, "--device", args.device])

    _main.__name__ = f"main_{data}_{task}"
    return _main


main_acdc_seg = _make_dataset_eval_main("acdc", "segmentation")
main_acdc_clf = _make_dataset_eval_main("acdc", "classification")
main_acdc_reg = _make_dataset_eval_main("acdc", "regression")
main_mnms_seg = _make_dataset_eval_main("mnms", "segmentation")
main_mnms_clf = _make_dataset_eval_main("mnms", "classification")
main_mnms_reg = _make_dataset_eval_main("mnms", "regression")
main_mnms2_seg = _make_dataset_eval_main("mnms2", "segmentation")
main_mnms2_clf = _make_dataset_eval_main("mnms2", "classification")
main_mnms2_reg = _make_dataset_eval_main("mnms2", "regression")
main_kaggle_seg = _make_dataset_eval_main("kaggle", "segmentation")
main_rescan_seg = _make_dataset_eval_main("rescan", "segmentation")
main_emidec_seg = _make_dataset_eval_main("emidec", "segmentation")
main_myops2020_seg = _make_dataset_eval_main("myops2020", "segmentation")
main_landmark_seg = _make_dataset_eval_main("landmark", "segmentation")
main_landmark_reg = _make_dataset_eval_main("landmark", "regression")


if __name__ == "__main__":
    main()

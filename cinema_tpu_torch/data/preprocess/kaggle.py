"""Kaggle second-annual Data Science Bowl DICOM preprocessing (port of cinema_tpu/data/preprocess/kaggle.py).

Reproduces the reference pipeline (cinema/data/kaggle/preprocess.py): per
study, load the 2ch/4ch LAX and the numbered SAX cine DICOM folders, filter
the SAX stack to the longest geometrically-consistent consecutive slice run,
resample to (1, 1, 10) mm, crop LAX 256^2 / SAX 192^2 around the LV center
from the 2C/4C plane intersection, percentile-normalise, and write uint8
NIfTI plus a metadata CSV with EDV/ESV-derived EF labels. The studies are processed in worker processes
(``spawn``: the caller may hold the card) and their rows kept in input order; the label tables are read with
pandas' types (``read_table``).

Usage:
    python -m cinema_tpu_torch.data.preprocess.kaggle --data_dir <second-annual-data-science-bowl>
                                                      --out_dir <out> [--max_n_cpus 4] [--splits train ...]
"""

from __future__ import annotations

import argparse
import contextlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cinema_tpu_torch.constants import UKB_LAX_SLICE_SIZE, UKB_SAX_SLICE_SIZE, UKB_SPACING
from cinema_tpu_torch.data.datasets import read_table, write_table
from cinema_tpu_torch.data.dicom import assemble_cine_volume, load_dicom_folder, load_series_frames
from cinema_tpu_torch.data.volume import Volume, get_origin_for_crop, get_sax_center
from cinema_tpu_torch.log import get_logger

logger = get_logger(__name__)

KAGGLE_SPACING = UKB_SPACING  # (1, 1, 10) mm (reference data/kaggle/__init__.py:24-26)
KAGGLE_SAX_SLICE_SIZE = UKB_SAX_SLICE_SIZE
KAGGLE_LAX_SLICE_SIZE = UKB_LAX_SLICE_SIZE

PIDS_TO_SKIP = [761]  # all-black images (reference kaggle/preprocess.py:28-30)


def find_longest_consecutive_subseq_with_same_values(
    values: Sequence,
) -> Tuple[int, int]:
    """(start, length) of the longest run of consecutive equal values
    (reference kaggle/preprocess.py:33-57)."""
    best_n, n = 0, 0
    best_start, start = -1, -1
    for i, x in enumerate(values):
        if i > 0 and np.all(np.asarray(x) == np.asarray(values[i - 1])):
            n += 1
        else:
            n = 1
            start = i
        if n > best_n:
            best_n, best_start = n, start
    return best_start, best_n


def filter_consistent_sax_slices(
    sizes: Sequence[Tuple[int, ...]],
    spacings: Sequence[Sequence[float]],
    directions: Sequence[np.ndarray],
    origins: Sequence[np.ndarray],
    decimals: int = 4,
) -> Tuple[int, int]:
    """Longest consecutive slice run with consistent geometry.

    Kaggle SAX stacks mix acquisitions; keep the longest run whose slice
    sizes, pixel spacings, directions, and inter-slice origin distances each
    stay constant (reference filter_sax_images, kaggle/preprocess.py:60-100).

    Returns:
        (start, count) into the slice list.
    """
    lo, hi = 0, len(sizes)

    def narrow(values: list) -> None:
        nonlocal lo, hi
        start, n = find_longest_consecutive_subseq_with_same_values(values)
        lo, hi = lo + start, lo + start + n

    narrow([tuple(s) for s in sizes])
    narrow([tuple(np.round(np.asarray(s), decimals)) for s in spacings[lo:hi]])
    narrow([tuple(np.round(np.asarray(d).reshape(-1), decimals)) for d in directions[lo:hi]])
    if hi - lo > 1:
        org = np.asarray(origins[lo:hi])
        gaps = np.round(np.linalg.norm(np.diff(org, axis=0), axis=-1), decimals)
        start, n = find_longest_consecutive_subseq_with_same_values(list(gaps))
        lo, hi = lo + start, lo + start + n + 1  # +1: run is on differences
    return lo, hi - lo


def _filter_sax_frames(sax_dirs: List[Path]) -> List[List]:
    """Drop geometrically-inconsistent SAX slice folders before assembly;
    returns the kept folders' parsed frame lists (each DICOM decoded ONCE —
    the filter volumes and the final assembly reuse the same parse)."""
    per_dir = [load_series_frames(d) for d in sax_dirs]
    metas = [assemble_cine_volume([frames]) for frames in per_dir]
    start, count = filter_consistent_sax_slices(
        sizes=[m.array.shape[:2] + (m.array.shape[-1],) for m in metas],
        spacings=[m.spacing[:2] for m in metas],
        directions=[m.rotation for m in metas],
        origins=[m.origin for m in metas],
    )
    return per_dir[start : start + count]


def crop_and_normalise_study(
    sax_image: Volume,
    lax_images: Dict[str, Volume],
    spacing: Sequence[float] = KAGGLE_SPACING,
    lax_slice_size: Tuple[int, int] = KAGGLE_LAX_SLICE_SIZE,
    sax_slice_size: Tuple[int, int] = KAGGLE_SAX_SLICE_SIZE,
) -> Tuple[Volume, Dict[str, Volume]]:
    """Shared resample -> LV-center crop -> normalise steps
    (reference kaggle/preprocess.py:134-194)."""
    lax_images = {
        k: v.resample((*spacing[:2], v.spacing[-1]), is_label=False)
        for k, v in lax_images.items()
    }
    sax_image = sax_image.resample(spacing, is_label=False)

    sax_center = get_sax_center(sax_image, lax_images["lax_2c"], lax_images["lax_4c"])
    if sax_center is None:
        raise ValueError("Failed to get the center of 2C/4C/SAX images for cropping.")

    lax_images = {
        k: v.crop_xy(get_origin_for_crop(sax_center, v, lax_slice_size), lax_slice_size)
        for k, v in lax_images.items()
    }
    sax_image = sax_image.crop_xy(
        get_origin_for_crop(sax_center, sax_image, sax_slice_size), sax_slice_size
    )

    lax_images = {k: v.clip_and_normalise() for k, v in lax_images.items()}
    sax_image = sax_image.clip_and_normalise()
    return sax_image, lax_images


def process_study(study_dir: Path, pid: str, out_dir: Path) -> Dict[str, float]:
    """Process one study folder into cropped uint8 NIfTI files
    (reference process_study, kaggle/preprocess.py:103-223)."""
    dir_2c = next(study_dir.glob("2ch_*"))
    dir_4c = next(study_dir.glob("4ch_*"))
    lax_2c_image = load_dicom_folder([dir_2c])  # (x, y, 1, t)
    lax_4c_image = load_dicom_folder([dir_4c])

    sax_dirs = sorted(study_dir.glob("sax_*"), key=lambda x: int(x.name.split("sax_")[1]))
    sax_frames = _filter_sax_frames(list(sax_dirs))
    sax_image = assemble_cine_volume(sax_frames)  # (x, y, z, t)
    orig_sax_spacing = tuple(sax_image.spacing)

    sax_image, lax_images = crop_and_normalise_study(
        sax_image, {"lax_2c": lax_2c_image, "lax_4c": lax_4c_image}
    )

    out_dir = out_dir / pid
    out_dir.mkdir(parents=True, exist_ok=True)
    lax_images["lax_2c"].to_uint8().save(out_dir / f"{pid}_lax_2c_t.nii.gz")
    lax_images["lax_4c"].to_uint8().save(out_dir / f"{pid}_lax_4c_t.nii.gz")
    sax_image.to_uint8().save(out_dir / f"{pid}_sax_t.nii.gz")

    return {
        "pid": int(pid),
        "n_slices": sax_image.size[2],
        # some studies have more SAX frames than LAX frames (reference :218)
        "n_frames": min(
            sax_image.size[-1],
            lax_images["lax_2c"].size[-1],
            lax_images["lax_4c"].size[-1],
        ),
        "original_sax_spacing_x": orig_sax_spacing[0],
        "original_sax_spacing_y": orig_sax_spacing[1],
        "original_sax_spacing_z": orig_sax_spacing[2],
    }


def try_process_study(study_dir: Path, pid: str, out_dir: Path) -> Dict[str, float]:
    try:
        return process_study(study_dir, pid, out_dir)
    except Exception:  # noqa: BLE001 - per-study isolation, matching the reference
        logger.exception(f"Failed to process {pid} for {study_dir}.")
    return {}


def load_labels(data_dir: Path, split: str) -> Tuple[List[str], List[Dict[str, Any]]]:
    """(columns, rows) of the volume labels with the derived EF (reference kaggle/preprocess.py:298-314)."""
    # here, not at the top: the worker processes import this module and need no torch
    from cinema_tpu_torch.metrics import ejection_fraction

    if split == "test":
        # pivot_table(index="Id", columns="phase", values="Volume"): the mean volume of each (Id, phase),
        # missing volumes skipped, the Ids sorted, a column per phase in sorted order, NaN where a pair is missing
        _, solution = read_table(data_dir / "solution.csv")
        volumes: Dict[int, Dict[str, List[float]]] = {}
        for row in solution:
            pid, phase = row["Id"].split("_")[0], row["Id"].split("_")[1]
            volumes.setdefault(int(pid), {}).setdefault(phase, []).append(float(row["Volume"]))
        phases = sorted({phase for by_phase in volumes.values() for phase in by_phase})

        def mean(values: List[float]) -> float:
            values = [v for v in values if not np.isnan(v)]
            return float(np.mean(values)) if values else float("nan")

        columns = ["Id", *phases]
        rows = [{"Id": pid, **{phase: mean(volumes[pid].get(phase, [])) for phase in phases}}
                for pid in sorted(volumes)]
    else:
        columns, rows = read_table(data_dir / f"{split}.csv")
    renames = {"Id": "pid", "Systole": "systole_volume", "Diastole": "diastole_volume"}
    if not set(renames) <= set(columns):
        raise KeyError(f"{sorted(set(renames) - set(columns))} not found in axis")
    columns = [renames.get(c, c) for c in columns] + ["ef"]
    rows = [{renames.get(c, c): v for c, v in row.items()} for row in rows]
    for row in rows:
        row["ef"] = float(ejection_fraction(edv=np.float64(row["diastole_volume"]),
                                            esv=np.float64(row["systole_volume"])))
    return columns, rows


def run(data_dir: Path, out_dir: Path, max_n_workers: int = 4, splits: Optional[List[str]] = None) -> None:
    """Process all splits (reference main, kaggle/preprocess.py:270-319); one pool of worker processes serves
    every split."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        pool = None
        if max_n_workers > 1:
            pool = stack.enter_context(
                ProcessPoolExecutor(max_workers=max_n_workers, mp_context=multiprocessing.get_context("spawn")))
        for split in splits or ["train", "validate", "test"]:
            _run_split(data_dir, out_dir, split, pool)


def _run_split(data_dir: Path, out_dir: Path, split: str, pool: Optional[ProcessPoolExecutor]) -> None:
    out_split = "val" if split == "validate" else split
    logger.info(f"Processing {split} split.")
    split_dir = data_dir / split / split
    study_dirs = [
        d for d in sorted(split_dir.glob("*/study"))
        if int(d.parent.name) not in PIDS_TO_SKIP
    ]
    jobs = [(d, d.parent.name, out_dir / out_split) for d in study_dirs]
    if pool is not None:
        data = list(pool.map(try_process_study, *zip(*jobs))) if jobs else []
    else:
        data = [try_process_study(*job) for job in jobs]
    data = [x for x in data if x]

    label_columns, labels = load_labels(data_dir, split)
    # pd.DataFrame(data).sort_values("pid").merge(label_df, on="pid", how="left"): the rows in pid order,
    # each with the label columns of every label row of its pid, or missing values where there is none
    by_pid: Dict[Any, List[Dict[str, Any]]] = {}
    for label in labels:
        by_pid.setdefault(label["pid"], []).append(label)
    label_columns = [c for c in label_columns if c != "pid"]
    rows = [{**row, **{c: label.get(c) for c in label_columns}}
            for row in sorted(data, key=lambda row: row["pid"]) for label in by_pid.get(row["pid"], [{}])]
    meta_df_path = out_dir / f"{out_split}_metadata.csv"
    write_table(meta_df_path, rows)
    logger.info(f"Saved metadata to {meta_df_path}.")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", type=Path, default=Path("second-annual-data-science-bowl"))
    parser.add_argument("--out_dir", type=Path, default=Path("processed"))
    parser.add_argument("--max_n_cpus", type=int, default=4)
    parser.add_argument("--splits", nargs="*", default=None, help="subset of train/validate/test")
    args = parser.parse_args(argv)
    run(args.data_dir, args.out_dir, max_n_workers=args.max_n_cpus, splits=args.splits)


if __name__ == "__main__":
    main()

"""M&Ms-2 preprocessing (port of cinema_tpu/data/preprocess/mnms2.py;
reference cinema/data/mnms2/preprocess.py).

Raw layout: <root>/dataset_information.csv + dataset/<pid>/<pid>_{SA,LA}_{ED,ES}.nii.gz
(+_gt). SAX handled like M&Ms; the 4-chamber LAX slice is resampled to
(1,1)mm and center-cropped to 256x256. Split by pid ranges (1-160 train,
161-200 val, 201-360 test). The raw table is read with pandas' types (``read_table``);
a row with an empty field is dropped, as ``.dropna()`` drops it.

Usage:
    python -m cinema_tpu_torch.data.preprocess.mnms2 --data_dir <raw M&Ms-2> --out_dir <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from cinema_tpu_torch.constants import (
    LV_LABEL,
    MYO_LABEL,
    RV_LABEL,
    UKB_LAX_SLICE_SIZE,
    UKB_SAX_SLICE_SIZE,
)
from cinema_tpu_torch.data.geometry import (
    cast_to_uint8,
    clip_and_normalise_intensity,
    crop_with_sizes,
    get_binary_mask_bounding_box,
    get_center_crop_size_from_bbox,
    resample_spacing,
)
from cinema_tpu_torch.data.datasets import iterrows, read_table, write_table
from cinema_tpu_torch.data.nifti import load_nifti, save_nifti
from cinema_tpu_torch.data.preprocess.acdc import remap_labels
from cinema_tpu_torch.log import get_logger
from cinema_tpu_torch.metrics import ejection_fraction

logger = get_logger(__name__)

MNMS2_SPACING = (1.0, 1.0, 10.0)
MNMS2_LAX_SPACING = (1.0, 1.0)
MNMS2_LABEL_MAP = {1: LV_LABEL, 2: MYO_LABEL, 3: RV_LABEL}


def preprocess_pid(row: Dict[str, Any], data_dir: Path, out_dir: Path) -> Dict:
    pid = str(int(row["pid"]))
    pid_dir = data_dir / pid
    data = dict(row)
    data["pid"] = pid

    # ---- SAX: ED/ES volumes, LV-centered crop like ACDC/M&Ms
    frames = {}
    for name, tag in [("ed", "ED"), ("es", "ES")]:
        image, h = load_nifti(pid_dir / f"{pid}_SA_{tag}.nii.gz")
        label, _ = load_nifti(pid_dir / f"{pid}_SA_{tag}_gt.nii.gz")
        label = remap_labels(label.astype(np.uint8), MNMS2_LABEL_MAP)
        image = resample_spacing(image, h.spacing, MNMS2_SPACING)
        label = resample_spacing(label, h.spacing, MNMS2_SPACING, is_label=True)
        frames[name] = (image, label)
    ed_label = frames["ed"][1]
    n_slices = ed_label.shape[-1]
    data["n_slices"] = n_slices
    bbox_min, bbox_max = get_binary_mask_bounding_box(ed_label == LV_LABEL)
    crop_lower, crop_upper = get_center_crop_size_from_bbox(
        bbox_min, bbox_max, ed_label.shape, (*UKB_SAX_SLICE_SIZE, n_slices)
    )
    out = out_dir / pid
    out.mkdir(parents=True, exist_ok=True)
    voxel_ml = float(np.prod(MNMS2_SPACING)) / 1000.0
    for name, (image, label) in frames.items():
        image = crop_with_sizes(image, crop_lower, crop_upper)
        label = crop_with_sizes(label, crop_lower, crop_upper)
        data[f"lv_{name}v"] = float((label == LV_LABEL).sum()) * voxel_ml
        image = clip_and_normalise_intensity(image)
        save_nifti(out / f"{pid}_sax_{name}.nii.gz", cast_to_uint8(image), spacing=MNMS2_SPACING)
        save_nifti(out / f"{pid}_sax_{name}_gt.nii.gz", label.astype(np.uint8), spacing=MNMS2_SPACING)
    data["ef"] = float(ejection_fraction(np.float64(data["lv_edv"]), np.float64(data["lv_esv"])))

    # ---- LAX 4C: single slice, label-bbox centered 256x256 crop
    for name, tag in [("ed", "ED"), ("es", "ES")]:
        image, h = load_nifti(pid_dir / f"{pid}_LA_{tag}.nii.gz")
        label, _ = load_nifti(pid_dir / f"{pid}_LA_{tag}_gt.nii.gz")
        label = remap_labels(label.astype(np.uint8), MNMS2_LABEL_MAP)
        image2d = resample_spacing(image[:, :, 0], h.spacing[:2], MNMS2_LAX_SPACING)
        label2d = resample_spacing(label[:, :, 0], h.spacing[:2], MNMS2_LAX_SPACING, is_label=True)
        bbox_min, bbox_max = get_binary_mask_bounding_box(label2d > 0)
        crop_lower2, crop_upper2 = get_center_crop_size_from_bbox(
            bbox_min, bbox_max, label2d.shape, UKB_LAX_SLICE_SIZE
        )
        image2d = crop_with_sizes(image2d, crop_lower2, crop_upper2)
        label2d = crop_with_sizes(label2d, crop_lower2, crop_upper2)
        image2d = clip_and_normalise_intensity(image2d)
        save_nifti(
            out / f"{pid}_lax_4c_{name}.nii.gz",
            cast_to_uint8(image2d)[..., None],
            spacing=(*MNMS2_LAX_SPACING, 1.0),
        )
        save_nifti(
            out / f"{pid}_lax_4c_{name}_gt.nii.gz",
            label2d.astype(np.uint8)[..., None],
            spacing=(*MNMS2_LAX_SPACING, 1.0),
        )
    return data


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess raw M&Ms-2.")
    parser.add_argument("--data_dir", type=Path, required=True)
    parser.add_argument("--out_dir", type=Path, required=True)
    args = parser.parse_args(argv)
    _, meta_rows = read_table(args.data_dir / "dataset_information.csv")
    # .dropna(): a row with a missing value goes; the columns keep the types read from every row
    meta_rows = [row for row in meta_rows if not any(isinstance(v, float) and np.isnan(v) for v in row.values())]
    renames = {
        "SUBJECT_CODE": "pid",
        "DISEASE": "pathology",
        "VENDOR": "vendor",
        "SCANNER": "scanner",
        "FIELD": "field",
    }
    meta_rows = [{renames.get(c, c): v for c, v in row.items()} for row in meta_rows]
    for row in meta_rows:
        row["pid"] = int(row["pid"])
    splits = {
        "train": [row for row in meta_rows if row["pid"] <= 160],
        "val": [row for row in meta_rows if 160 < row["pid"] <= 200],
        "test": [row for row in meta_rows if row["pid"] > 200],
    }
    data_dir = args.data_dir / "dataset"
    for split, split_rows in splits.items():
        rows = []
        for row in iterrows(split_rows):
            logger.info(f"Preprocessing {row['pid']}.")
            rows.append(preprocess_pid(row, data_dir, args.out_dir / split))
        write_table(args.out_dir / f"{split}_metadata.csv", rows)


if __name__ == "__main__":
    main()

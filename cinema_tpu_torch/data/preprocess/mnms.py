"""M&Ms preprocessing (port of cinema_tpu/data/preprocess/mnms.py; reference cinema/data/mnms/preprocess.py).

Raw layout: <root>/211230_M&Ms_Dataset_information_diagnosis_opendataset.csv
+ Training/Labeled|Validation|Testing/<pid>/<pid>_sa.nii.gz (+_sa_gt.nii.gz,
4D with labelled ED/ES frames). Pipeline mirrors ACDC: extract ED/ES frames
by csv index, remap labels {1:LV->3, 2:MYO, 3:RV->1}, resample to (1,1,10),
LV-centered 192x192 crop, volumes/EF, clip-norm, uint8. The raw table is read with
pandas' types (``read_table``), so the metadata written carries them as the JAX CLI's does.

Usage:
    python -m cinema_tpu_torch.data.preprocess.mnms --data_dir <raw M&Ms> --out_dir <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from cinema_tpu_torch.constants import LV_LABEL, MYO_LABEL, RV_LABEL, UKB_SAX_SLICE_SIZE
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
from cinema_tpu_torch.log import get_logger
from cinema_tpu_torch.metrics import ejection_fraction
from cinema_tpu_torch.data.preprocess.acdc import remap_labels

logger = get_logger(__name__)

MNMS_SPACING = (1.0, 1.0, 10.0)
MNMS_SAX_SLICE_SIZE = UKB_SAX_SLICE_SIZE
MNMS_LABEL_MAP = {1: LV_LABEL, 2: MYO_LABEL, 3: RV_LABEL}


def preprocess_pid(row: Dict[str, Any], split_dir: Path, out_dir: Path) -> Dict:
    pid = str(row["pid"])
    video, h4 = load_nifti(split_dir / pid / f"{pid}_sa.nii.gz")
    labels4d, _ = load_nifti(split_dir / pid / f"{pid}_sa_gt.nii.gz")
    spacing = h4.spacing[:3]
    data = dict(row)
    data["original_sax_spacing_x"], data["original_sax_spacing_y"], data["original_sax_spacing_z"] = spacing

    frames = {}
    for name, idx in [("ed", int(row["ed_index"])), ("es", int(row["es_index"]))]:
        image = video[..., idx]
        label = remap_labels(labels4d[..., idx].astype(np.uint8), MNMS_LABEL_MAP)
        image = resample_spacing(image, spacing, MNMS_SPACING)
        label = resample_spacing(label, spacing, MNMS_SPACING, is_label=True)
        frames[name] = (image, label)

    ed_label = frames["ed"][1]
    n_slices = ed_label.shape[-1]
    data["n_slices"] = n_slices
    bbox_min, bbox_max = get_binary_mask_bounding_box(ed_label == LV_LABEL)
    crop_lower, crop_upper = get_center_crop_size_from_bbox(
        bbox_min, bbox_max, ed_label.shape, (*MNMS_SAX_SLICE_SIZE, n_slices)
    )
    frames = {
        k: (crop_with_sizes(i, crop_lower, crop_upper), crop_with_sizes(l, crop_lower, crop_upper))
        for k, (i, l) in frames.items()
    }
    voxel_ml = float(np.prod(MNMS_SPACING)) / 1000.0
    data["lv_edv"] = float((frames["ed"][1] == LV_LABEL).sum()) * voxel_ml
    data["lv_esv"] = float((frames["es"][1] == LV_LABEL).sum()) * voxel_ml
    data["lv_ef"] = float(ejection_fraction(np.float64(data["lv_edv"]), np.float64(data["lv_esv"])))
    data["rv_edv"] = float((frames["ed"][1] == RV_LABEL).sum()) * voxel_ml
    data["rv_esv"] = float((frames["es"][1] == RV_LABEL).sum()) * voxel_ml
    data["rv_ef"] = float(ejection_fraction(np.float64(data["rv_edv"]), np.float64(data["rv_esv"])))
    data["ef"] = data["lv_ef"]

    out = out_dir / pid
    out.mkdir(parents=True, exist_ok=True)
    for name, (image, label) in frames.items():
        image = clip_and_normalise_intensity(image)
        save_nifti(out / f"{pid}_sax_{name}.nii.gz", cast_to_uint8(image), spacing=MNMS_SPACING)
        save_nifti(out / f"{pid}_sax_{name}_gt.nii.gz", label.astype(np.uint8), spacing=MNMS_SPACING)
    return data


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess raw M&Ms.")
    parser.add_argument("--data_dir", type=Path, required=True)
    parser.add_argument("--out_dir", type=Path, required=True)
    args = parser.parse_args(argv)
    columns, meta_rows = read_table(args.data_dir / "211230_M&Ms_Dataset_information_diagnosis_opendataset.csv")
    renames = {
        "External code": "pid",
        "Pathology": "pathology",
        "VendorName": "vendor_name",
        "Vendor": "vendor",
        "Centre": "center",
        "ED": "ed_index",
        "ES": "es_index",
        "Age": "age",
        "Sex": "sex",
        "Height": "height",
        "Weight": "weight",
    }
    # .iloc[:, 1:] drops the first (index) column, then the columns are renamed where named above
    meta_rows = [{renames.get(c, c): row[c] for c in columns[1:]} for row in meta_rows]
    for split, sub in [("train", Path("Training") / "Labeled"), ("val", Path("Validation")), ("test", Path("Testing"))]:
        split_dir = args.data_dir / sub
        if not split_dir.exists():
            logger.warning(f"{split_dir} does not exist, skipping.")
            continue
        pids = {p.name for p in split_dir.iterdir() if p.is_dir()}
        rows = []
        for row in iterrows([row for row in meta_rows if row["pid"] in pids]):
            logger.info(f"Preprocessing {row['pid']}.")
            rows.append(preprocess_pid(row, split_dir, args.out_dir / split))
        write_table(args.out_dir / f"{split}_metadata.csv", rows)


if __name__ == "__main__":
    main()

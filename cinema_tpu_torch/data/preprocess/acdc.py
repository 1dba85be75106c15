"""ACDC preprocessing (port of cinema_tpu/data/preprocess/acdc.py; reference cinema/data/acdc/preprocess.py).

Raw layout (per patient): patientXXX/
    Info.cfg (ED/ES frames, Group, Height, Weight, NbFrame)
    patientXXX_4d.nii.gz, patientXXX_frameYY.nii.gz (+_gt)

Pipeline per patient (reference acdc/preprocess.py:74-204): unify labels ->
resample to (1,1,10)mm -> center-crop 192x192 around the LV bbox from the ED
label -> compute LV/RV EDV/ESV/EF -> percentile-clip z-norm -> uint8 NIfTI +
train/test metadata.csv.

Usage:
    python -m cinema_tpu_torch.data.preprocess.acdc --data_dir <raw ACDC with training/ testing/> --out_dir <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

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
from cinema_tpu_torch.data.datasets import write_table
from cinema_tpu_torch.data.nifti import load_nifti, save_nifti
from cinema_tpu_torch.log import get_logger
from cinema_tpu_torch.metrics import ejection_fraction

logger = get_logger(__name__)

ACDC_SPACING = (1.0, 1.0, 10.0)
ACDC_SAX_SLICE_SIZE = UKB_SAX_SLICE_SIZE
# original classes: RV=1, MYO=2, LV=3 (identical to the unified labels)
ACDC_LABEL_MAP = {3: LV_LABEL, 2: MYO_LABEL, 1: RV_LABEL}


def load_info_cfg(path: Path) -> Dict[str, float | str]:
    """Parse Info.cfg key: value lines."""
    data: Dict[str, float | str] = {"pid": path.parent.name}
    for line in path.read_text().splitlines():
        if ":" not in line:
            continue
        key, value = line.split(":", 1)
        value = value.strip()
        try:
            data[key.strip().lower()] = float(value) if "." in value else int(value)
        except ValueError:
            data[key.strip().lower()] = value
    return data


def remap_labels(label: np.ndarray, label_map: Dict[int, int]) -> np.ndarray:
    out = np.zeros_like(label)
    for src, dst in label_map.items():
        out[label == src] = dst
    return out


def preprocess_pid(pid_dir: Path, out_dir: Path) -> Dict:
    info = load_info_cfg(pid_dir / "Info.cfg")
    pid = str(info["pid"])
    ed, es = int(info["ed"]), int(info["es"])

    video, header4d = load_nifti(pid_dir / f"{pid}_4d.nii.gz")
    spacing = header4d.spacing[:3]
    info["original_sax_spacing_x"] = spacing[0]
    info["original_sax_spacing_y"] = spacing[1]
    info["original_sax_spacing_z"] = spacing[2]

    frames = {}
    for name, idx in [("ed", ed), ("es", es)]:
        image, h = load_nifti(pid_dir / f"{pid}_frame{idx:02d}.nii.gz")
        label, _ = load_nifti(pid_dir / f"{pid}_frame{idx:02d}_gt.nii.gz")
        label = remap_labels(label.astype(np.uint8), ACDC_LABEL_MAP)
        image = resample_spacing(image, h.spacing, ACDC_SPACING)
        label = resample_spacing(label, h.spacing, ACDC_SPACING, is_label=True)
        frames[name] = (image, label)
    video = resample_spacing(video, spacing, ACDC_SPACING)

    ed_image, ed_label = frames["ed"]
    n_slices = ed_label.shape[-1]
    info["n_slices"] = n_slices
    bbox_min, bbox_max = get_binary_mask_bounding_box(ed_label == LV_LABEL)
    crop_lower, crop_upper = get_center_crop_size_from_bbox(
        bbox_min, bbox_max, ed_label.shape, (*ACDC_SAX_SLICE_SIZE, n_slices)
    )
    video = crop_with_sizes(video, crop_lower, crop_upper)
    frames = {k: (crop_with_sizes(i, crop_lower, crop_upper), crop_with_sizes(l, crop_lower, crop_upper))
              for k, (i, l) in frames.items()}

    voxel_ml = float(np.prod(ACDC_SPACING)) / 1000.0
    info["lv_edv"] = float((frames["ed"][1] == LV_LABEL).sum()) * voxel_ml
    info["lv_esv"] = float((frames["es"][1] == LV_LABEL).sum()) * voxel_ml
    info["lv_ef"] = float(ejection_fraction(np.float64(info["lv_edv"]), np.float64(info["lv_esv"])))
    info["rv_edv"] = float((frames["ed"][1] == RV_LABEL).sum()) * voxel_ml
    info["rv_esv"] = float((frames["es"][1] == RV_LABEL).sum()) * voxel_ml
    info["rv_ef"] = float(ejection_fraction(np.float64(info["rv_edv"]), np.float64(info["rv_esv"])))
    info["ef"] = info["lv_ef"]
    info["pathology"] = info.get("group", "")
    if "height" in info and "weight" in info and float(info["height"]) > 0:
        info["bmi"] = float(info["weight"]) / (float(info["height"]) / 100.0) ** 2

    video = clip_and_normalise_intensity(video)
    out = out_dir / pid
    out.mkdir(parents=True, exist_ok=True)
    save_nifti(out / f"{pid}_sax_t.nii.gz", cast_to_uint8(video), spacing=(*ACDC_SPACING, 1.0))
    for name, (image, label) in frames.items():
        image = clip_and_normalise_intensity(image)
        save_nifti(out / f"{pid}_sax_{name}.nii.gz", cast_to_uint8(image), spacing=ACDC_SPACING)
        save_nifti(out / f"{pid}_sax_{name}_gt.nii.gz", label.astype(np.uint8), spacing=ACDC_SPACING)
    return info


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess raw ACDC into the training layout.")
    parser.add_argument("--data_dir", type=Path, required=True, help="raw ACDC root with training/ testing/")
    parser.add_argument("--out_dir", type=Path, required=True)
    args = parser.parse_args(argv)
    for split, raw_name in [("train", "training"), ("test", "testing")]:
        raw = args.data_dir / raw_name
        if not raw.exists():
            logger.warning(f"{raw} does not exist, skipping {split}.")
            continue
        rows = []
        for pid_dir in sorted(raw.glob("patient*")):
            logger.info(f"Preprocessing {pid_dir.name}.")
            rows.append(preprocess_pid(pid_dir, args.out_dir / split))
        write_table(args.out_dir / f"{split}_metadata.csv", rows)
        logger.info(f"Wrote {len(rows)} rows to {split}_metadata.csv.")


if __name__ == "__main__":
    main()

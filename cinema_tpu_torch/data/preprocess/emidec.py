"""EMIDEC preprocessing (port of cinema_tpu/data/preprocess/emidec.py;
reference cinema/data/emidec/preprocess.py).

Raw layout: data_dir/Case <pid>.txt + data_dir/Case_<pid>/{Images,Contours}/Case_<pid>.nii.gz.
Pipeline: resample to (1.458, 1.458, 10)mm -> crop 192x192 around the
myocardium (class 2) bbox -> percentile-clip z-norm -> uint8 NIfTI +
clinical metadata csv with a random train/val/test split.

Usage:
    python -m cinema_tpu_torch.data.preprocess.emidec --data_dir <raw EMIDEC> --out_dir <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from cinema_tpu_torch.constants import UKB_SAX_SLICE_SIZE
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

logger = get_logger(__name__)

EMIDEC_SPACING = (1.458, 1.458, 10.0)
EMIDEC_SLICE_SIZE = UKB_SAX_SLICE_SIZE


def preprocess_pid(pid: str, data_dir: Path, out_dir: Path) -> Dict:
    lines = (data_dir / f"Case {pid}.txt").read_text(encoding="unicode_escape").splitlines()
    raw = {x.split(":")[0].strip(): x.split(":", 1)[1].strip() for x in lines if ":" in x}
    data: Dict = {
        "pid": pid,
        "sex": raw.get("Sex", ""),
        "age": int(float(raw.get("Age", 0))),
        "ef": float(raw.get("FEVG", 0)),
        "pathology": pid[0],
    }

    image, h = load_nifti(data_dir / f"Case_{pid}" / "Images" / f"Case_{pid}.nii.gz")
    label, _ = load_nifti(data_dir / f"Case_{pid}" / "Contours" / f"Case_{pid}.nii.gz")
    data["orig_spacing_x"], data["orig_spacing_y"], data["orig_spacing_z"] = h.spacing[:3]

    image = resample_spacing(image, h.spacing, EMIDEC_SPACING)
    label = resample_spacing(label.astype(np.uint8), h.spacing, EMIDEC_SPACING, is_label=True)
    if label.min() < 0 or label.max() > 4:
        raise ValueError(f"Invalid label values: {np.unique(label)} for {pid}.")
    n_slices = label.shape[-1]
    data["n_slices"] = n_slices
    bbox_min, bbox_max = get_binary_mask_bounding_box(label == 2)  # myocardium center
    crop_lower, crop_upper = get_center_crop_size_from_bbox(
        bbox_min, bbox_max, label.shape, (*EMIDEC_SLICE_SIZE, n_slices)
    )
    image = crop_with_sizes(image, crop_lower, crop_upper)
    label = crop_with_sizes(label, crop_lower, crop_upper)
    for cls_idx in range(1, 5):
        data[f"cls_{cls_idx}_proportion"] = float((label == cls_idx).mean())

    image = clip_and_normalise_intensity(image)
    out = out_dir / "train" / pid
    out.mkdir(parents=True, exist_ok=True)
    save_nifti(out / f"{pid}.nii.gz", cast_to_uint8(image), spacing=EMIDEC_SPACING)
    save_nifti(out / f"{pid}_gt.nii.gz", label.astype(np.uint8), spacing=EMIDEC_SPACING)
    return data


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess raw EMIDEC into the training layout.")
    parser.add_argument("--data_dir", type=Path, required=True)
    parser.add_argument("--out_dir", type=Path, required=True)
    args = parser.parse_args(argv)
    pids = sorted(x.stem.split(" ")[1] for x in args.data_dir.glob("Case *.txt"))
    rows = []
    for pid in pids:
        logger.info(f"Preprocessing {pid}.")
        rows.append(preprocess_pid(pid, args.data_dir, args.out_dir))
    write_table(args.out_dir / "train_metadata.csv", rows)
    logger.info(f"Wrote {len(rows)} rows.")


if __name__ == "__main__":
    main()

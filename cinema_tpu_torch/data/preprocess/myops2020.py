"""MyoPS2020 preprocessing (port of cinema_tpu/data/preprocess/myops2020.py; reference
cinema/data/myops2020/preprocess.py).

Raw layout: train25/myops_training_<pid>_{C0,DE,T2}.nii.gz +
train25_myops_gd/myops_training_<pid>_gd.nii.gz (test20 without labels).
Pipeline: NO resampling (inference must map back); center-crop 192x192 in
x/y; remap labels {600:1, 500:2, 200:3, 1220:4, 2221:5}; per-modality
percentile-clip z-norm -> uint8.

Usage:
    python -m cinema_tpu_torch.data.preprocess.myops2020 --data_dir <root with train25/ train25_myops_gd/ test20/>
                                                         --out_dir <out>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from cinema_tpu_torch.constants import UKB_SAX_SLICE_SIZE
from cinema_tpu_torch.data.geometry import cast_to_uint8, clip_and_normalise_intensity, crop_with_sizes
from cinema_tpu_torch.data.datasets import write_table
from cinema_tpu_torch.data.nifti import load_nifti, save_nifti
from cinema_tpu_torch.log import get_logger

logger = get_logger(__name__)

MYOPS2020_SLICE_SIZE = UKB_SAX_SLICE_SIZE
MYOPS2020_LABEL_MAP = {600: 1, 500: 2, 200: 3, 1220: 4, 2221: 5}


def preprocess_pid(
    pid: str,
    split: str,
    image_dir: Path,
    out_dir: Path,
    label_dir: Optional[Path] = None,
) -> Dict:
    out = out_dir / pid
    out.mkdir(parents=True, exist_ok=True)
    data: Dict = {"pid": pid}

    arrays = {}
    spacing = None
    for key, tag in [("c0", "C0"), ("de", "DE"), ("t2", "T2")]:
        arr, h = load_nifti(image_dir / f"myops_{split}_{pid}_{tag}.nii.gz")
        arrays[key] = arr
        spacing = h.spacing
    data["orig_spacing_x"], data["orig_spacing_y"], data["orig_spacing_z"] = spacing[:3]
    size = arrays["c0"].shape
    data["n_slices"] = size[-1]
    lo_x = (size[0] - MYOPS2020_SLICE_SIZE[0]) // 2
    up_x = size[0] - MYOPS2020_SLICE_SIZE[0] - lo_x
    lo_y = (size[1] - MYOPS2020_SLICE_SIZE[1]) // 2
    up_y = size[1] - MYOPS2020_SLICE_SIZE[1] - lo_y
    data.update(crop_lower_x=lo_x, crop_lower_y=lo_y, crop_upper_x=up_x, crop_upper_y=up_y)
    crop_lower, crop_upper = (lo_x, lo_y, 0), (up_x, up_y, 0)

    for key, arr in arrays.items():
        arr = crop_with_sizes(arr, crop_lower, crop_upper)
        arr = clip_and_normalise_intensity(arr)
        save_nifti(out / f"{pid}_{key}.nii.gz", cast_to_uint8(arr), spacing=spacing[:3])

    if label_dir is not None:
        label, _ = load_nifti(label_dir / f"myops_{split}_{pid}_gd.nii.gz")
        remapped = np.zeros_like(label, dtype=np.uint8)
        for src, dst in MYOPS2020_LABEL_MAP.items():
            remapped[label == src] = dst
        remapped = crop_with_sizes(remapped, crop_lower, crop_upper)
        save_nifti(out / f"{pid}_gt.nii.gz", remapped, spacing=spacing[:3])
    return data


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess raw MyoPS2020.")
    parser.add_argument("--data_dir", type=Path, required=True, help="root with train25/, train25_myops_gd/, test20/")
    parser.add_argument("--out_dir", type=Path, required=True)
    args = parser.parse_args(argv)
    for split, img_sub, lbl_sub in [
        ("training", "train25", "train25_myops_gd"),
        ("test", "test20", None),
    ]:
        image_dir = args.data_dir / img_sub
        if not image_dir.exists():
            logger.warning(f"{image_dir} does not exist, skipping.")
            continue
        label_dir = args.data_dir / lbl_sub if lbl_sub else None
        pids = sorted({p.name.split("_")[2] for p in image_dir.glob(f"myops_{split}_*_C0.nii.gz")})
        rows = []
        out_split = "train" if split == "training" else "test"
        for pid in pids:
            logger.info(f"Preprocessing {pid}.")
            rows.append(preprocess_pid(pid, split, image_dir, args.out_dir / out_split, label_dir))
        write_table(args.out_dir / f"{out_split}_metadata.csv", rows)


if __name__ == "__main__":
    main()

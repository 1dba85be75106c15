"""Rescan (test-retest) pickle -> NIfTI preprocessing (port of cinema_tpu/data/preprocess/rescan.py).

Reproduces the reference pipeline (cinema/data/rescan/preprocess.py): each
scan is stored as pickled dicts of voxel arrays plus DICOM geometry tags.
The labeled splits (train/test) convert SAX image+segmentation and 2C/4C
LAX cines to oriented volumes, resample to (1, 1, 10) mm, crop around the
2C/4C/SAX plane-intersection LV center, normalise, and derive ED/ES frame
indices from LV volume extrema; the ``test_retest_100`` split processes the
paired A/B1/B2 scans with EDV/ESV/EF labels for the reproducibility study. ``labels.csv`` is read with
pandas' types (``read_table``).

Usage:
    python -m cinema_tpu_torch.data.preprocess.rescan --data_dir <pickle root> --out_dir <out>
                                                      [--splits train test test_retest_100]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from cinema_tpu_torch.constants import (
    LV_LABEL,
    MYO_LABEL,
    RV_LABEL,
    UKB_LAX_SLICE_SIZE,
    UKB_SAX_SLICE_SIZE,
    UKB_SPACING,
)
from cinema_tpu_torch.data.datasets import iterrows, read_table, write_table
from cinema_tpu_torch.data.volume import Volume, get_origin_for_crop, get_sax_center
from cinema_tpu_torch.log import get_logger
from cinema_tpu_torch.metrics import ejection_fraction

logger = get_logger(__name__)

RESCAN_SPACING = UKB_SPACING  # (reference data/rescan/__init__.py:18-21)
RESCAN_SAX_SLICE_SIZE = UKB_SAX_SLICE_SIZE
RESCAN_LAX_SLICE_SIZE = UKB_LAX_SLICE_SIZE
# source labels 1=LV, 2=MYO, 3=RV -> unified RV=1, MYO=2, LV=3
RESCAN_LABEL_MAP = {1: LV_LABEL, 2: MYO_LABEL, 3: RV_LABEL}


def load_pickle(path: Path) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)


def _orientation_to_rotation(orientation: np.ndarray) -> np.ndarray:
    """DICOM orientation (6,) -> (3,3) rotation with columns row/col/normal
    (reference dicom_orientation_to_rotation_matrix, data/dicom.py:294-310)."""
    a = np.asarray(orientation[:3], dtype=np.float64)
    b = np.asarray(orientation[3:6], dtype=np.float64)
    return np.stack([a, b, np.cross(a, b)], axis=1)


def remap_labels(label: np.ndarray, label_map: Dict[int, int]) -> np.ndarray:
    """Value remap (reference sitk.ChangeLabel usage, rescan/preprocess.py:83)."""
    out = label.copy()
    for src, dst in label_map.items():
        out[label == src] = dst
    return out


def sax_to_volume(sax: Dict[str, np.ndarray], frame: Optional[int] = None) -> Volume:
    """One SAX cine pickle -> Volume (x, y, z[, t]).

    Pickle stores (z, t, y, x) with apex-first z; the reference flips z and
    anchors the origin at the LAST ImagePositionPatient row
    (rescan/preprocess.py:56-77).
    """
    voxels = sax["image_voxels"]  # (z, t, y, x)
    arr = voxels[::-1]  # base-first
    if frame is not None:
        arr = arr[:, frame]
        arr = np.transpose(arr, (2, 1, 0))  # (x, y, z)
    else:
        arr = np.transpose(arr, (3, 2, 0, 1))  # (x, y, z, t)
    spacing = np.array(
        [sax["PixelSpacing"][0], sax["PixelSpacing"][1], sax["SliceSpacing"]], dtype=np.float64
    )
    return Volume(
        array=np.ascontiguousarray(arr),
        origin=np.asarray(sax["ImagePositionPatient"])[-1, :],
        spacing=spacing,
        rotation=_orientation_to_rotation(np.asarray(sax["ImageOrientationPatient"])),
    )


def lax_to_volume(lax: Dict[str, np.ndarray], slice_spacing: float = 1.0) -> Volume:
    """One LAX cine pickle (t, y, x) -> Volume (x, y, 1, t)
    (reference lax_to_nifti, rescan/preprocess.py:145-188)."""
    voxels = lax["image_voxels"]  # (t, y, x)
    arr = np.transpose(voxels, (2, 1, 0))[:, :, None, :]  # (x, y, 1, t)
    spacing = np.array(
        [lax["PixelSpacing"][0], lax["PixelSpacing"][1], slice_spacing], dtype=np.float64
    )
    return Volume(
        array=np.ascontiguousarray(arr),
        origin=np.asarray(lax["ImagePositionPatient"], dtype=np.float64),
        spacing=spacing,
        rotation=_orientation_to_rotation(np.asarray(lax["ImageOrientationPatient"])),
    )


def crop_scan(
    sax_image: Volume,
    sax_label: Optional[Volume],
    lax_2c_image: Volume,
    lax_4c_image: Volume,
) -> Tuple[Volume, Optional[Volume], Volume, Volume]:
    """Resample + LV-center crop + normalise (reference crop,
    rescan/preprocess.py:211-276)."""
    sax_image = sax_image.resample(RESCAN_SPACING, is_label=False)
    if sax_label is not None:
        sax_label = sax_label.resample(RESCAN_SPACING, is_label=True)
    lax_2c_image = lax_2c_image.resample(
        (*RESCAN_SPACING[:2], lax_2c_image.spacing[-1]), is_label=False
    )
    lax_4c_image = lax_4c_image.resample(
        (*RESCAN_SPACING[:2], lax_4c_image.spacing[-1]), is_label=False
    )

    sax_center = get_sax_center(sax_image, lax_2c_image, lax_4c_image)
    if sax_center is None:
        raise ValueError("Failed to get SAX center.")

    lax_2c_image = lax_2c_image.crop_xy(
        get_origin_for_crop(sax_center, lax_2c_image, RESCAN_LAX_SLICE_SIZE),
        RESCAN_LAX_SLICE_SIZE,
    )
    lax_4c_image = lax_4c_image.crop_xy(
        get_origin_for_crop(sax_center, lax_4c_image, RESCAN_LAX_SLICE_SIZE),
        RESCAN_LAX_SLICE_SIZE,
    )
    sax_indices = get_origin_for_crop(sax_center, sax_image, RESCAN_SAX_SLICE_SIZE)
    sax_image = sax_image.crop_xy(sax_indices, RESCAN_SAX_SLICE_SIZE)
    if sax_label is not None:
        sax_label = sax_label.crop_xy(sax_indices, RESCAN_SAX_SLICE_SIZE)

    return (
        sax_image.clip_and_normalise(),
        sax_label,
        lax_2c_image.clip_and_normalise(),
        lax_4c_image.clip_and_normalise(),
    )


def _load_scan_pickles(scan_dir: Path, with_label: bool):
    """(lax_2c, lax_4c, sax[, sax_label]) dicts, or None when incomplete."""
    names = ["2C.pickle", "4C.pickle", "SAX.pickle"] + (
        ["SAX_segs.pickle"] if with_label else []
    )
    loaded = []
    for name in names:
        path = scan_dir / name
        if not path.exists():
            logger.error(f"{path} does not exist.")
            return None
        data = load_pickle(path)
        if len(data) == 0:
            logger.error(f"Failed to load pickle file {path}.")
            return None
        loaded.append(data)
    return loaded


def process(data_dir: Path, out_dir: Path, split: str) -> None:
    """Labeled splits: SAX image+segmentation and LAX cines with ED/ES
    indices (reference process, rescan/preprocess.py:279-393)."""
    data_df_path = out_dir / f"{split}_metadata.csv"
    split_data_dir = data_dir / split
    split_out_dir = out_dir / split

    records = []
    folder_paths = sorted({p.parent for p in split_data_dir.glob("**/SAX.pickle")})
    for folder_path in folder_paths:
        relative_path = folder_path.relative_to(split_data_dir)
        loaded = _load_scan_pickles(folder_path, with_label=True)
        if loaded is None:
            continue
        lax_2c, lax_4c, sax, sax_label_raw = loaded
        slice_spacing = float(sax["SliceSpacing"])

        sax_image = sax_to_volume(sax)
        label_dict = dict(sax_label_raw)
        label_dict["image_voxels"] = remap_labels(
            np.asarray(sax_label_raw["image_segmentation"]), RESCAN_LABEL_MAP
        ).astype(np.uint8)
        label_dict.setdefault("ImagePositionPatient", sax["ImagePositionPatient"])
        label_dict.setdefault("ImageOrientationPatient", sax["ImageOrientationPatient"])
        label_dict.setdefault("PixelSpacing", sax["PixelSpacing"])
        label_dict.setdefault("SliceSpacing", sax["SliceSpacing"])
        sax_label = sax_to_volume(label_dict)

        sax_image, sax_label, lax_2c_image, lax_4c_image = crop_scan(
            sax_image, sax_label, lax_to_volume(lax_2c, slice_spacing), lax_to_volume(lax_4c, slice_spacing)
        )

        lv_volumes = np.sum(sax_label.array == LV_LABEL, axis=(0, 1, 2))  # per frame
        records.append(
            {
                "pid": str(relative_path),
                "orig_sax_spacing_x": float(sax["PixelSpacing"][0]),
                "orig_sax_spacing_y": float(sax["PixelSpacing"][1]),
                "orig_sax_spacing_z": slice_spacing,
                "orig_lax_spacing_x": float(lax_2c["PixelSpacing"][0]),
                "orig_lax_spacing_y": float(lax_2c["PixelSpacing"][1]),
                "n_slices": sax_image.size[2],
                "n_frames": sax_image.size[3],
                "ed_index": int(np.argmax(lv_volumes)),
                "es_index": int(np.argmin(lv_volumes)),
            }
        )

        out_dir_i = split_out_dir / relative_path
        out_dir_i.mkdir(parents=True, exist_ok=True)
        sax_image.save(out_dir_i / "sax_t.nii.gz")
        sax_label.save(out_dir_i / "sax_gt_t.nii.gz")
        lax_2c_image.save(out_dir_i / "lax_2c_t.nii.gz")
        lax_4c_image.save(out_dir_i / "lax_4c_t.nii.gz")

    write_table(data_df_path, records)
    logger.info(f"Saved metadata to {data_df_path}.")


def process_paired(data_dir: Path, out_dir: Path, split: str = "test_retest_100") -> None:
    """Paired test-retest scans A/B1/B2 with EDV/ESV/EF labels
    (reference process_paired, rescan/preprocess.py:396-497)."""
    data_df_path = out_dir / f"{split}_metadata.csv"
    split_data_dir = data_dir / split
    split_out_dir = out_dir / split

    _, label_rows = read_table(split_data_dir / "labels.csv")
    records = []
    for i, row in enumerate(iterrows(label_rows)):
        ids = [int(row["A"]), int(row["B1"])]
        vs = "AB"
        if not np.isnan(row["B2"]):
            ids.append(int(row["B2"]))
            vs += "B"

        for j, v in zip(ids, vs):
            pid = f"scan_{i:02d}_{v}"
            loaded = _load_scan_pickles(split_data_dir / str(j), with_label=False)
            if loaded is None:
                continue
            lax_2c, lax_4c, sax = loaded
            slice_spacing = float(sax["SliceSpacing"])

            sax_image, _, lax_2c_image, lax_4c_image = crop_scan(
                sax_to_volume(sax),
                None,
                lax_to_volume(lax_2c, slice_spacing),
                lax_to_volume(lax_4c, slice_spacing),
            )

            if v == "A":
                edv, esv = row["EDV_A"], row["ESV_A"]
            else:
                edv = np.nanmean(np.array([row["EDV_B1"], row["EDV_B2"]], dtype=np.float64))
                esv = np.nanmean(np.array([row["ESV_B1"], row["ESV_B2"]], dtype=np.float64))

            records.append(
                {
                    "pid": pid,
                    "orig_sax_spacing_x": float(sax["PixelSpacing"][0]),
                    "orig_sax_spacing_y": float(sax["PixelSpacing"][1]),
                    "orig_sax_spacing_z": slice_spacing,
                    "orig_lax_spacing_x": float(lax_2c["PixelSpacing"][0]),
                    "orig_lax_spacing_y": float(lax_2c["PixelSpacing"][1]),
                    "n_slices": sax_image.size[2],
                    "n_frames": sax_image.size[3],
                    "edv": edv,
                    "esv": esv,
                    "ef": ejection_fraction(edv, esv),
                }
            )

            out_dir_i = split_out_dir / pid
            out_dir_i.mkdir(parents=True, exist_ok=True)
            sax_image.save(out_dir_i / "sax_t.nii.gz")
            lax_2c_image.save(out_dir_i / "lax_2c_t.nii.gz")
            lax_4c_image.save(out_dir_i / "lax_4c_t.nii.gz")

    # B1 and B2 both map to pid scan_NN_B (the reference's zip(ids, "ABB"),
    # rescan/preprocess.py:411-419) so B2's NIfTIs overwrite B1's on disk;
    # keep only the LAST metadata row per pid so metadata matches the files
    # instead of carrying a duplicate pid (drop_duplicates(subset="pid", keep="last"))
    last = {record["pid"]: i for i, record in enumerate(records)}
    write_table(data_df_path, [record for i, record in enumerate(records) if last[record["pid"]] == i])
    logger.info(f"Saved metadata to {data_df_path}.")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", type=Path, default=Path("pickle"))
    parser.add_argument("--out_dir", type=Path, default=Path("processed"))
    parser.add_argument(
        "--splits",
        nargs="*",
        default=["test_retest_100"],
        help="any of train/test (labeled) and test_retest_100 (paired)",
    )
    args = parser.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    for split in args.splits:
        if split == "test_retest_100":
            process_paired(args.data_dir, args.out_dir, split=split)
        else:
            process(args.data_dir, args.out_dir, split=split)


if __name__ == "__main__":
    main()

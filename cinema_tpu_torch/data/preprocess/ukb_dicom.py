"""UK Biobank DICOM -> NIfTI conversion and LV-centered cropping (port of
cinema_tpu/data/preprocess/ukb_dicom.py).

Reproduces the reference pipeline (cinema/examples/dicom_to_nifti.py): fix
the date format in the UKB manifest CSV, split the flat DICOM folders into
per-series subfolders by the manifest's "series discription" column, load
the CINE LAX 2/3/4-chamber series and the numbered SAX slice series into 4D
volumes, then resample to (1, 1, 10) mm, crop LAX 256^2 / SAX 192^2 around
the LV center (2C/4C plane intersection, projected onto the 3C plane for the
3C crop), normalise, and write uint8 NIfTI files. This is the ingest path
for the 69,779-study pretrain corpus. The manifest is read and written back with pandas' types
(``read_table``, ``write_table``): a column of integers stays integers, a numeric column with an empty
field comes back as floats.

Usage:
    python -m cinema_tpu_torch.data.preprocess.ukb_dicom --lax_dicom_dir <eid>_20209_2_0
                                                         --sax_dicom_dir <eid>_20208_2_0 --out_dir <out>
                                                         [--no_frame_index]
"""

from __future__ import annotations

import argparse
import re
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from cinema_tpu_torch.constants import UKB_LAX_SLICE_SIZE, UKB_SAX_SLICE_SIZE, UKB_SPACING
from cinema_tpu_torch.data.datasets import read_table, write_table
from cinema_tpu_torch.data.dicom import load_dicom_folder
from cinema_tpu_torch.data.volume import (
    Volume,
    get_origin_for_crop,
    get_sax_center,
    point_to_plane_projection,
)
from cinema_tpu_torch.log import get_logger

logger = get_logger(__name__)

SERIES_COLUMN = "series discription"  # sic — the UKB manifest misspells it


def date_repl(m: "re.Match[str]") -> str:
    """'Aug 30, 2015' -> '30-Aug-2015' (reference dicom_to_nifti.py:52-67)."""
    return f"{m.group(3)}-{m.group(1)}{m.group(2)}-20{m.group(4)}"


def fix_manifest(manifest_path: Path, fixed_manifest_path: Path) -> None:
    """Strip the comma-containing date format that breaks CSV parsing
    (reference dicom_to_nifti.py:70-87)."""
    with open(fixed_manifest_path, "w", encoding="utf-8") as f_fixed, open(
        manifest_path, encoding="utf-8"
    ) as f:
        for line in f:
            f_fixed.write(re.sub(r"([A-Z])(\w{2}) (\d{1,2}), 20(\d{2})", date_repl, line))


Manifest = Tuple[List[str], List[Dict[str, Any]]]


def find_fix_and_read_manifest(unzip_dir: Path, out_path: Path) -> Optional[Manifest]:
    """Locate, fix and parse the manifest file: (columns, rows)
    (reference dicom_to_nifti.py:89-107)."""
    manifest_paths = sorted(unzip_dir.glob("manifest.*"))
    if len(manifest_paths) == 0:
        logger.error(f"Failed to find manifest in {unzip_dir}.")
        return None
    if len(manifest_paths) > 1:
        logger.error(
            f"Found multiple manifest in {unzip_dir}, using the first found {manifest_paths[0]}."
        )
    fix_manifest(manifest_paths[0], out_path)
    return read_table(out_path)


def _unique(values: List[Any]) -> List[Any]:
    """``Series.unique()``: the values in order of first appearance, a missing value (NaN) once."""
    nans = [v for v in values if isinstance(v, float) and np.isnan(v)]
    keys = dict.fromkeys(None if isinstance(v, float) and np.isnan(v) else v for v in values)
    return [nans[0] if k is None else k for k in keys]


def get_sax_series(sax_manifest_rows: List[Dict[str, Any]], folder_id: str) -> List[int]:
    """Numbered SAX series, validated contiguous from 1
    (reference dicom_to_nifti.py:183-197)."""
    series = _unique([row[SERIES_COLUMN] for row in sax_manifest_rows])
    nums = sorted(
        int(x.replace("CINE_segmented_SAX_b", ""))
        for x in series
        if isinstance(x, str) and re.match(r"CINE_segmented_SAX_b\d+$", x)
    )
    if set(nums) != set(range(1, len(nums) + 1)):
        raise ValueError(
            f"SAX files are not continuous for {folder_id}: got series discription for {nums}."
        )
    return nums


def split_dicom_files_and_convert(
    dicom_dir: Path,
    nifti_dir: Path,
    eid: str,
    instance_id: str,
    suffix: str,
) -> Tuple[Dict[str, Volume], List[Dict[str, Any]]]:
    """Split flat DICOM files into per-series folders, assemble volumes
    (reference split_dicom_files_and_convert_to_nifti,
    dicom_to_nifti.py:110-168)."""
    fixed_manifest_path = dicom_dir / f"{eid}_{instance_id}_manifest_{suffix}.csv"
    manifest = find_fix_and_read_manifest(dicom_dir, fixed_manifest_path)
    if manifest is None:
        raise ValueError(f"Failed to find manifest in {dicom_dir}.")
    columns, manifest_rows = manifest

    # groupby(SERIES_COLUMN): the series sorted, a row without one in none, each series' rows in file order
    groups: Dict[Any, List[Dict[str, Any]]] = {}
    for row in manifest_rows:
        if not (isinstance(row[SERIES_COLUMN], float) and np.isnan(row[SERIES_COLUMN])):
            groups.setdefault(row[SERIES_COLUMN], []).append(row)
    for series_name in sorted(groups):
        if "InlineVF" in str(series_name) or "Inline_VF_Results" in str(series_name):
            continue  # known-bad derived series (reference :136-140)
        series_dir = dicom_dir / str(series_name)
        series_dir.mkdir(parents=True, exist_ok=True)
        for row in groups[series_name]:
            shutil.copy(dicom_dir / row["filename"], series_dir / row["filename"])

    series_name_to_volume: Dict[str, Volume] = {}
    if suffix == "lax":
        for series_name in _unique([row[SERIES_COLUMN] for row in manifest_rows]):
            if "InlineVF" in str(series_name) or "Inline_VF_Results" in str(series_name):
                continue  # skipped above: no series folder exists for these
            series_dir = dicom_dir / str(series_name)
            volume = load_dicom_folder([series_dir])
            volume.save(nifti_dir / f"{eid}_{instance_id}_{series_name}.nii.gz")
            series_name_to_volume[str(series_name)] = volume
    else:
        nums = get_sax_series(manifest_rows, f"{eid}_{instance_id}")
        series_dirs = [dicom_dir / f"CINE_segmented_SAX_b{n}" for n in nums]
        volume = load_dicom_folder(series_dirs)
        volume.save(nifti_dir / f"{eid}_{instance_id}_CINE_segmented_SAX.nii.gz")
        series_name_to_volume["CINE_segmented_SAX"] = volume

    # persist the fixed manifest next to the NIfTI outputs (reference :163-166)
    write_table(nifti_dir / f"{eid}_{instance_id}_manifest_{suffix}.csv", manifest_rows, columns=columns)
    return series_name_to_volume, manifest_rows


@dataclass
class EIDData:
    """One participant's assembled views (reference dicom_to_nifti.py:171-181)."""

    eid: str
    instance_id: str
    lax_2c_image: Volume  # (x, y, 1, t)
    lax_3c_image: Volume
    lax_4c_image: Volume
    sax_image: Volume  # (x, y, z, t)


def transform_to_nifti(lax_dicom_dir: Path, sax_dicom_dir: Path, out_dir: Path) -> EIDData:
    """DICOM -> per-view 4D NIfTI for one participant
    (reference dicom_to_nifti.py:200-253)."""
    eid = lax_dicom_dir.stem.split("_")[0]
    instance_id = lax_dicom_dir.stem.split("_")[-2]
    folder_id = f"{eid}_{instance_id}"
    nifti_dir = out_dir / folder_id
    nifti_dir.mkdir(parents=True, exist_ok=True)

    lax_volumes, _ = split_dicom_files_and_convert(
        lax_dicom_dir, nifti_dir, eid, instance_id, suffix="lax"
    )
    for i in (2, 3, 4):
        if f"CINE_segmented_LAX_{i}Ch" not in lax_volumes:
            raise ValueError(f"LAX {i}C file for {folder_id} is not loaded.")
    sax_volumes, _ = split_dicom_files_and_convert(
        sax_dicom_dir, nifti_dir, eid, instance_id, suffix="sax"
    )
    return EIDData(
        eid=eid,
        instance_id=instance_id,
        lax_2c_image=lax_volumes["CINE_segmented_LAX_2Ch"],
        lax_3c_image=lax_volumes["CINE_segmented_LAX_3Ch"],
        lax_4c_image=lax_volumes["CINE_segmented_LAX_4Ch"],
        sax_image=sax_volumes["CINE_segmented_SAX"],
    )


def crop_nifti(
    data: EIDData,
    out_dir: Path,
    spacing: Tuple[float, ...] = UKB_SPACING,
    lax_slice_size: Tuple[int, int] = UKB_LAX_SLICE_SIZE,
    sax_slice_size: Tuple[int, int] = UKB_SAX_SLICE_SIZE,
    frame_indexed: bool = True,
) -> None:
    """Resample, LV-center crop (3C via plane projection), normalise, save
    uint8 (reference crop_nifti, dicom_to_nifti.py:256-388)."""
    if len(spacing) != 3:
        raise ValueError(f"Spacing should have 3 elements, got {spacing}.")

    lax_2c = data.lax_2c_image.resample((*spacing[:2], data.lax_2c_image.spacing[-1]))
    lax_3c = data.lax_3c_image.resample((*spacing[:2], data.lax_3c_image.spacing[-1]))
    lax_4c = data.lax_4c_image.resample((*spacing[:2], data.lax_4c_image.spacing[-1]))
    sax = data.sax_image.resample(spacing)

    sax_center = get_sax_center(sax, lax_2c, lax_4c)
    if sax_center is None:
        raise ValueError("Failed to get the center of 2C/4C/SAX images for cropping.")
    lax_3c_center = point_to_plane_projection(
        point=sax_center, plane_origin=lax_3c.origin, plane_norm_vec=lax_3c.rotation[:, -1]
    )

    lax_2c = lax_2c.crop_xy(get_origin_for_crop(sax_center, lax_2c, lax_slice_size), lax_slice_size)
    lax_3c = lax_3c.crop_xy(
        get_origin_for_crop(lax_3c_center, lax_3c, lax_slice_size), lax_slice_size
    )
    lax_4c = lax_4c.crop_xy(get_origin_for_crop(sax_center, lax_4c, lax_slice_size), lax_slice_size)
    sax = sax.crop_xy(get_origin_for_crop(sax_center, sax, sax_slice_size), sax_slice_size)

    folder_id = f"{data.eid}_{data.instance_id}"
    nifti_dir = out_dir / folder_id
    nifti_dir.mkdir(parents=True, exist_ok=True)
    # frame-indexed by default: the pretrain loader reads one random frame
    # per step, and the per-frame gzip members make that O(1) instead of a
    # whole-prefix inflate (see data/nifti.py; ~13-60x per-item read win)
    fi = frame_indexed
    lax_2c.clip_and_normalise().to_uint8().save(nifti_dir / f"{folder_id}_lax_2c.nii.gz", frame_indexed=fi)
    lax_3c.clip_and_normalise().to_uint8().save(nifti_dir / f"{folder_id}_lax_3c.nii.gz", frame_indexed=fi)
    lax_4c.clip_and_normalise().to_uint8().save(nifti_dir / f"{folder_id}_lax_4c.nii.gz", frame_indexed=fi)
    sax.clip_and_normalise().to_uint8().save(nifti_dir / f"{folder_id}_sax.nii.gz", frame_indexed=fi)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--lax_dicom_dir", type=Path, required=True)
    parser.add_argument("--sax_dicom_dir", type=Path, required=True)
    parser.add_argument("--out_dir", type=Path, required=True)
    parser.add_argument(
        "--no_frame_index",
        action="store_true",
        help="write plain single-member .nii.gz instead of frame-indexed",
    )
    args = parser.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    data = transform_to_nifti(args.lax_dicom_dir, args.sax_dicom_dir, args.out_dir)
    crop_nifti(data, args.out_dir, frame_indexed=not args.no_frame_index)


if __name__ == "__main__":
    main()

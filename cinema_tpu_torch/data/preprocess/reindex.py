"""Rewrite existing 4D .nii.gz files as frame-indexed gzip (port of cinema_tpu/data/preprocess/reindex.py).

Already-preprocessed datasets (e.g. a UKB tree produced by the reference's
``dicom_to_nifti`` or an earlier ``ukb_preprocess`` run) store each study as
one single-member gzip stream, so the pretrain loader's random-frame read
must inflate the whole prefix (nt/2 frames wasted on average — the measured
per-item bound of the input pipeline). This CLI rewrites them in place (or
into ``--out_dir``) as one gzip member per frame with an FEXTRA offset table
(see ``cinema_tpu_torch/data/nifti.py``): byte-identical voxels and geometry,
still a valid .nii.gz for any standard reader, O(1) frame access for ours.

Usage:
    python -m cinema_tpu_torch.data.preprocess.reindex --data_dir /data/ukb [--out_dir /data/ukb_indexed]
                                                       [--pattern '*_t.nii.gz'] [--n_workers 8]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

from cinema_tpu_torch.data.nifti import (
    load_nifti,
    load_nifti_header,
    read_frame_index,
    save_nifti,
)
from cinema_tpu_torch.log import get_logger

logger = get_logger(__name__)


def reindex_file(path: Path, out_path: Optional[Path] = None) -> str:
    """Rewrite one 4D .nii.gz as frame-indexed; returns a status string.

    In-place rewrites go through a same-directory temp file + os.replace so
    concurrent readers never see a partial file.
    """
    header = load_nifti_header(path)
    if len(header.shape) != 4:
        return "skip:not-4d"
    if out_path is None and read_frame_index(path) is not None:
        return "skip:already-indexed"
    # raw stored voxels, no scl scaling: the rewrite is lossless (same
    # dtype, same values) and the original scl fields ride along in the
    # new header so every reader keeps applying the same scaling
    array, header = load_nifti(path, apply_scaling=False)
    target = out_path or path
    target.parent.mkdir(parents=True, exist_ok=True)
    # tmp must keep the .gz suffix: save_nifti keys compression (and the
    # frame index) off the path extension
    tmp = target.parent / f".tmp{os.getpid()}.{target.name}"
    try:
        save_nifti(
            tmp,
            array,
            spacing=header.spacing[: array.ndim],
            affine=header.affine,
            descrip=header.descrip or b"cinema_tpu",
            frame_indexed=True,
            scl=(header.scl_slope, header.scl_inter),
        )
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return "ok"


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", type=Path, required=True)
    parser.add_argument(
        "--out_dir",
        type=Path,
        default=None,
        help="mirror the tree here instead of rewriting in place",
    )
    parser.add_argument(
        "--pattern",
        default="*.nii.gz",
        help="glob for candidate files (non-4D matches are skipped)",
    )
    parser.add_argument("--n_workers", type=int, default=os.cpu_count() or 1)
    args = parser.parse_args(argv)

    files = sorted(args.data_dir.rglob(args.pattern))
    if not files:
        logger.warning(f"No files matching {args.pattern} under {args.data_dir}.")
        return

    def job(path: Path) -> str:
        out = (
            args.out_dir / path.relative_to(args.data_dir) if args.out_dir else None
        )
        try:
            return reindex_file(path, out)
        except Exception as e:  # one bad file must not sink the sweep
            logger.error(f"{path}: {e}")
            return "error"

    with ThreadPoolExecutor(max_workers=max(1, args.n_workers)) as pool:
        statuses = list(pool.map(job, files))
    counts: dict = {}
    for s in statuses:
        counts[s] = counts.get(s, 0) + 1
    logger.info(f"Reindexed {len(files)} files: {counts}.")


if __name__ == "__main__":
    main()

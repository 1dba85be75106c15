"""Landmark dataset preprocessing (port of cinema_tpu/data/preprocess/landmark.py; reference
cinema/data/landmark/preprocess.py).

Raw layout: <root>/{lax_2c,lax_4c}.csv (cohort_name, uid, view,
landmark_number, x, y) + <root>/<view>/{images,masks}/<uid>.png.
Pipeline: downscale by ``scale``, extract 3 landmark coordinates, write
grayscale PNGs + per-view train/val/test CSVs with x1..y3 columns.

Without PIL: the image is read by ``read_png_gray`` (``Image.open(...).convert("L")``), downscaled by
:func:`resize_bicubic`, which is Pillow's ``Image.resize`` of an ``L`` image pixel for pixel, and written by
``viz.write_png``; the tables are read and written with pandas' types (``read_table``, ``write_table``).

Usage:
    python -m cinema_tpu_torch.data.preprocess.landmark --data_dir <root> --out_dir <out> [--view lax_2c]
                                                        [--scale 0.25]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from cinema_tpu_torch.data.datasets import read_png_gray, read_table, write_table
from cinema_tpu_torch.log import get_logger
from cinema_tpu_torch.train.loop import pandas_sample
from cinema_tpu_torch.viz import write_png

logger = get_logger(__name__)

# Pillow's fixed point of the 8-bit resampling (libImaging/Resample.c: PRECISION_BITS = 32 - 8 - 2)
_PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter, a = -0.5 (libImaging/Resample.c ``bicubic_filter``), support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), fixed-point weights (out, taps)) of one axis, as Pillow's
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them: the bicubic filter stretched by the
    downscale, each output's taps summed in order and divided by their sum, rounded half away from zero to
    ``_PRECISION_BITS`` bits; a tap beyond the input's edge has weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) of a value >= -0.5: 0 either way
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = _bicubic((np.arange(taps)[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where(np.arange(taps)[None, :] < xmax[:, None], k, 0.0)
    total = np.zeros(out_size)
    for x in range(taps):  # in Pillow's order: a pairwise sum could round otherwise
        total += k[:, x]
    k = np.where(total[:, None] != 0.0, k / np.where(total == 0.0, 1.0, total)[:, None], k)
    fixed = np.trunc(k * (1 << _PRECISION_BITS) + np.where(k < 0, -0.5, 0.5)).astype(np.int64)
    return xmin, fixed


def _resample_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's ``ImagingResampleHorizontal_8bpc`` / ``ImagingResampleVertical_8bpc`` along
    ``axis`` of a uint8 image: the fixed-point sum from half a unit, shifted down and clipped to 0..255."""
    image = np.moveaxis(image, axis, 0).astype(np.int64)
    xmin, fixed = _resample_coefficients(image.shape[0], out_size)
    acc = np.full((out_size,) + image.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for x in range(fixed.shape[1]):
        index = np.minimum(xmin + x, image.shape[0] - 1)  # a clamped tap has weight 0
        acc += image[index] * fixed[:, x].reshape((-1,) + (1,) * (image.ndim - 1))
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """A uint8 (height, width) image resized to ``size`` = (width, height) as Pillow's ``Image.resize(size)``
    resizes an ``L`` image (its default filter, bicubic, in 8-bit fixed point; libImaging/Resample.c
    ``ImagingResampleInner``): the horizontal pass, then the vertical pass; an axis whose size stays is not
    resampled. (Pillow's horizontal pass skips the rows that the vertical pass does not read; a row's result
    does not depend on the others, so the output is the same.)"""
    width, height = int(size[0]), int(size[1])
    out = image.copy()
    if width != image.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != image.shape[0]:
        out = _resample_axis(out, height, 0)
    return out


def process_view(data_dir: Path, out_dir: Path, view: str, scale: float = 0.25) -> None:
    _, meta_rows = read_table(
        data_dir / f"{view}.csv",
        names=["cohort_name", "uid", "view", "landmark_number", "x", "y"],
    )
    img_dir = out_dir / view / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    groups = {}  # groupby("uid"): the keys sorted, a missing key in no group, rows in file order
    for row in meta_rows:
        if not (isinstance(row["uid"], float) and np.isnan(row["uid"])):
            groups.setdefault(row["uid"], []).append(row)
    rows = []
    for uid in sorted(groups):
        group = groups[uid]
        image_path = data_dir / view / "images" / f"{uid}.png"
        if not image_path.exists():
            logger.warning(f"{image_path} missing, skipping.")
            continue
        image = read_png_gray(image_path).T.astype(np.uint8)  # (height, width), as PIL holds it
        new_size = (int(image.shape[1] * scale), int(image.shape[0] * scale))
        write_png(img_dir / f"{uid}.png", resize_bicubic(image, new_size))
        group = sorted(group, key=lambda r: r["landmark_number"])
        coords = (np.array([[r["x"], r["y"]] for r in group], dtype=np.float64) * scale).round().astype(int)
        if len(coords) != 3:
            logger.warning(f"{uid} has {len(coords)} landmarks, skipping.")
            continue
        rows.append(
            {
                "uid": uid,
                "view": view,
                "path": f"{view}/images/{uid}.png",
                "x1": coords[0, 0],
                "y1": coords[0, 1],
                "x2": coords[1, 0],
                "y2": coords[1, 1],
                "x3": coords[2, 0],
                "y3": coords[2, 1],
            }
        )
    columns = list(rows[0]) if rows else []
    # deterministic 8/1/1 split: the order of df.sample(frac=1.0, random_state=0)
    n = len(rows)
    rows = [rows[i] for i in pandas_sample(n, n, np.random.RandomState(0))]
    train, val = rows[: int(0.8 * n)], rows[int(0.8 * n) : int(0.9 * n)]
    test = rows[int(0.9 * n) :]
    for name, part in (("train", train), ("val", val), ("test", test)):
        csv_path = out_dir / f"{name}_metadata.csv"
        part_columns = columns
        if csv_path.exists():
            # merge with the other view's rows instead of overwriting them
            # (processing lax_2c then lax_4c into one out_dir); re-running
            # the same view replaces its own rows; pd.concat's columns: the old
            # table's, then the new ones
            old_columns, old = read_table(csv_path)
            if "view" in old_columns:
                old = [r for r in old if r["view"] != view]
            part_columns = list(dict.fromkeys(old_columns + columns))
            part = old + part
        write_table(csv_path, part, columns=part_columns)
    logger.info(f"{view}: {len(train)}/{len(val)}/{len(test)} train/val/test.")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess the landmark PNG dataset.")
    parser.add_argument("--data_dir", type=Path, required=True)
    parser.add_argument("--out_dir", type=Path, required=True)
    parser.add_argument("--view", type=str, default="lax_2c", choices=["lax_2c", "lax_4c"])
    parser.add_argument("--scale", type=float, default=0.25)
    args = parser.parse_args(argv)
    process_view(args.data_dir, args.out_dir, args.view, args.scale)


if __name__ == "__main__":
    main()

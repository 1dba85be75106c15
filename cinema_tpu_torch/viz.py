"""Pictures of the inference examples, without PIL or matplotlib (port of cinema_tpu/viz.py:40-186; reference
cinema/examples/inference/segmentation_sax.py:19-107 and mae.py:14-56).

The machine with the card has neither PIL nor matplotlib, so this module writes its PNGs (:func:`write_png`)
and GIFs (:func:`save_gif`) itself with the standard library's ``zlib`` and ``struct``. The pictures show
what the JAX package's show (the same panels, colours and curves) but cannot equal matplotlib's pixels:
there is no figure layout, no anti-aliasing and no text (no font rasteriser; the scripts print the numbers
the JAX figures write in titles). What the tests hold to the JAX package is the numbers returned
(:func:`plot_volume_changes`), the frame count and delay of a GIF, and the overlay colour at labelled pixels.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Sequence, Union

import numpy as np

from cinema_tpu_torch.constants import LV_LABEL, MYO_LABEL, RV_LABEL

# the JAX package's overlay colours (cinema_tpu/viz.py:20-24): RV blue, MYO gold, LV green, at 0.6 alpha
_LABEL_RGBA = {
    RV_LABEL: (108 / 255, 142 / 255, 191 / 255, 0.6),
    MYO_LABEL: (214 / 255, 182 / 255, 86 / 255, 0.6),
    LV_LABEL: (130 / 255, 179 / 255, 102 / 255, 0.6),
}
# the volume curves' colours (cinema_tpu/viz.py:134-136)
_CURVE_RGB = {RV_LABEL: (0x6C, 0x8E, 0xBF), MYO_LABEL: (0xD6, 0xB6, 0x56), LV_LABEL: (0x82, 0xB3, 0x66)}
# gray levels of the segmentation GIF's panels: 64 grays, each blended with the three colours, fill the
# GIF's 256-colour palette exactly
GIF_GRAY_LEVELS = 64
_WHITE = 255

PathLike = Union[str, Path]


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: PathLike, array: np.ndarray) -> None:
    """Write a uint8 image as an 8-bit PNG: ``(height, width)`` gray or ``(height, width, 3)`` RGB, rows top
    to bottom as PIL's ``Image.fromarray`` takes them; every row with filter 0 (None), zlib, CRCs."""
    array = np.asarray(array)
    if array.dtype != np.uint8 or not (array.ndim == 2 or (array.ndim == 3 and array.shape[2] == 3)):
        raise ValueError(f"Expected a uint8 (h, w) or (h, w, 3) image, got {array.dtype} {array.shape}.")
    height, width = array.shape[:2]
    colour_type = 0 if array.ndim == 2 else 2
    rows = np.ascontiguousarray(array).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8, colour_type, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) + _png_chunk(b"IDAT", zlib.compress(raw))
                           + _png_chunk(b"IEND", b""))


def _palette_indices(frames: np.ndarray) -> tuple:
    """(palette (n, 3) uint8 with n <= 256, per-pixel indices uint8 of ``frames`` (n_frames, h, w, 3)).

    The palette is the frames' colours where there are at most 256 of them; otherwise every colour is
    quantized to 3 bits of red and green and 2 of blue (each bin shown by its centre)."""
    packed = (frames[..., 0].astype(np.uint32) << 16) | (frames[..., 1].astype(np.uint32) << 8) | frames[..., 2]
    colours, inverse = np.unique(packed, return_inverse=True)
    if len(colours) > 256:
        bins = ((frames[..., 0] >> 5).astype(np.uint32) << 5) | ((frames[..., 1] >> 5).astype(np.uint32) << 2) \
            | (frames[..., 2] >> 6)
        colours, inverse = np.unique(bins, return_inverse=True)
        palette = np.stack([(colours >> 5 & 7) * 32 + 16, (colours >> 2 & 7) * 32 + 16, (colours & 3) * 64 + 32],
                           axis=-1).astype(np.uint8)
    else:
        palette = np.stack([colours >> 16 & 255, colours >> 8 & 255, colours & 255], axis=-1).astype(np.uint8)
    return palette, inverse.reshape(frames.shape[:3]).astype(np.uint8)


def _lzw(indices: bytes, min_code_size: int) -> bytes:
    """GIF's variable-width LZW of a frame's palette indices: a clear code first, codes growing from
    ``min_code_size + 1`` bits to 12 as the table fills, a clear code and a fresh table when it is full
    (4096 codes), the end code last; bits packed least significant first."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    size = min_code_size + 1
    acc, n_acc = clear, size  # the clear code, emitted first
    if not indices:
        acc |= end << n_acc
        return (acc).to_bytes((n_acc + size + 7) // 8, "little")
    table: Dict[int, int] = {}
    lookup = table.get
    next_code, limit = end + 1, 1 << size
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = lookup(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << n_acc
        n_acc += size
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > limit and size < 12:
                size += 1
                limit <<= 1
        else:
            acc |= clear << n_acc
            n_acc += size
            table.clear()
            next_code, size = end + 1, min_code_size + 1
            limit = 1 << size
        if n_acc >= 64:
            out += (acc & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
            acc >>= 64
            n_acc -= 64
        prefix = k
    acc |= prefix << n_acc
    n_acc += size
    acc |= end << n_acc
    n_acc += size
    return bytes(out) + acc.to_bytes((n_acc + 7) // 8, "little")


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255)) + b"\x00"


def save_gif(frames: Sequence[np.ndarray], path: PathLike, duration_ms: int = 50) -> None:
    """Write an animated GIF89a of ``(h, w, 3)`` uint8 frames: one global palette of at most 256 colours
    (:func:`_palette_indices`), LZW-coded frames, a NETSCAPE loop count of 0 (forever) and a delay of
    ``duration_ms // 10`` hundredths of a second per frame, as PIL's ``save(..., duration, loop=0)``."""
    frames = np.stack([np.asarray(f, np.uint8) for f in frames])
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"Expected (h, w, 3) frames, got {frames.shape[1:]}.")
    n_frames, height, width, _ = frames.shape
    palette, indices = _palette_indices(frames)
    bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[: len(palette)] = palette
    min_code_size = max(2, bits)
    parts = [b"GIF89a", struct.pack("<HHBBB", width, height, 0x80 | (bits - 1), 0, 0), table.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    delay = int(duration_ms) // 10
    for t in range(n_frames):
        parts.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0))
        parts.append(bytes([min_code_size]) + _sub_blocks(_lzw(indices[t].tobytes(), min_code_size)))
    parts.append(b"\x3b")
    Path(path).write_bytes(b"".join(parts))


def _minmax(panel: np.ndarray) -> np.ndarray:
    """A panel scaled to [0, 1] by its own minimum and maximum, as ``imshow`` scales it; a constant panel is 0."""
    panel = np.asarray(panel, np.float64)
    lo, hi = panel.min(), panel.max()
    return (panel - lo) / (hi - lo) if hi > lo else np.zeros_like(panel)


def overlay_colours(gray: np.ndarray, label: np.ndarray) -> np.ndarray:
    """One segmentation panel as uint8 RGB: ``gray`` (a panel scaled to [0, 1]) quantized to
    ``GIF_GRAY_LEVELS`` levels, and where ``label`` is RV, MYO or LV that level blended with the label's
    colour at alpha 0.6, ``round(255 * (0.6 * colour + 0.4 * gray))``, as matplotlib composites the JAX
    package's RGBA overlay."""
    level = np.round(gray * (GIF_GRAY_LEVELS - 1)) / (GIF_GRAY_LEVELS - 1)
    rgb = np.repeat(level[..., None], 3, axis=-1)
    for value, (*colour, alpha) in _LABEL_RGBA.items():
        hit = label == value
        rgb[hit] = alpha * np.asarray(colour) + (1 - alpha) * level[hit, None]
    return np.round(rgb * 255).astype(np.uint8)


def plot_segmentations_gif(images: np.ndarray, labels: np.ndarray, path: PathLike, t_step: int = 1) -> None:
    """Animated cine segmentation (the JAX package's ``plot_segmentations_gif``): per frame ``0, t_step,
    ...`` a grid of 3 columns of slices, slice z at row ``z // 3``, column ``z % 3``, each panel the
    ``(x, y)`` slice with x down, min-max scaled, RV, MYO and LV overlaid (:func:`overlay_colours`); empty
    grid cells white. A delay of ``50 * t_step`` ms a frame.

    Args:
        images: (x, y, z, t) grayscale.
        labels: (x, y, z, t) integer labels.
        path: output ``.gif``.
        t_step: temporal stride between rendered frames.
    """
    nx, ny = labels.shape[:2]
    n_slices, n_frames = labels.shape[-2:]
    n_cols = min(3, n_slices)
    n_rows = (n_slices + n_cols - 1) // n_cols
    frames = []
    for t in range(0, n_frames, t_step):
        canvas = np.full((n_rows * nx, n_cols * ny, 3), _WHITE, np.uint8)
        for z in range(n_slices):
            r, c = z // n_cols, z % n_cols
            canvas[r * nx : (r + 1) * nx, c * ny : (c + 1) * ny] = overlay_colours(
                _minmax(images[..., z, t]), labels[..., z, t])
        frames.append(canvas)
    save_gif(frames, path, duration_ms=50 * t_step)


def _draw_line(canvas: np.ndarray, p0: tuple, p1: tuple, colour: tuple, width: int = 2) -> None:
    """A segment from ``p0`` to ``p1`` ((row, column) floats), ``width`` pixels wide, onto an RGB canvas."""
    n = int(np.ceil(2 * max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])))) + 1
    rows = np.round(np.linspace(p0[0], p1[0], n)).astype(int)
    cols = np.round(np.linspace(p0[1], p1[1], n)).astype(int)
    for dr in range(width):
        for dc in range(width):
            r = np.clip(rows + dr - width // 2, 0, canvas.shape[0] - 1)
            c = np.clip(cols + dc - width // 2, 0, canvas.shape[1] - 1)
            canvas[r, c] = colour


def plot_volume_changes(labels: np.ndarray, path: PathLike, t_step: int = 1,
                        ml_per_voxel: float = 10.0 / 1000.0) -> dict:
    """Ventricle and myocardium volume curves (the JAX package's ``plot_volume_changes``): the RV, MYO and LV
    volumes of every frame, in ml, against the frame (``index * t_step``), drawn in the JAX colours on plain
    axes (no text) into a 400x400 RGB PNG.

    Args:
        labels: (x, y, z, t) integer labels.
        path: output ``.png``.
        t_step: frame stride used when the labels were subsampled.
        ml_per_voxel: voxel volume in ml (the reference's default is UKB's 1x1x10 mm).

    Returns:
        {"lvef": float, "rvef": float} in percent from the curves' extremes, NaN where a maximum is 0: the
        JAX function's dict.
    """
    n_frames = labels.shape[-1]
    xs = np.arange(n_frames) * t_step
    volumes = {value: np.sum(labels == value, axis=(0, 1, 2)) * ml_per_voxel for value in _CURVE_RGB}
    rv, lv = volumes[RV_LABEL], volumes[LV_LABEL]
    lvef = float((lv.max() - lv.min()) / lv.max() * 100) if lv.max() > 0 else float("nan")
    rvef = float((rv.max() - rv.min()) / rv.max() * 100) if rv.max() > 0 else float("nan")

    size, margin = 400, 40
    canvas = np.full((size, size, 3), _WHITE, np.uint8)
    top, bottom, left, right = margin, size - margin, margin, size - margin
    x_max = max(float(xs[-1]), 1.0)
    y_max = max(max(float(v.max()) for v in volumes.values()) * 1.05, 1e-12)

    def point(x: float, y: float) -> tuple:
        return bottom - (bottom - top) * y / y_max, left + (right - left) * x / x_max

    for value, ys in volumes.items():
        pts = [point(x, y) for x, y in zip(xs, ys)]
        for p0, p1 in zip(pts, pts[1:] or pts):
            _draw_line(canvas, p0, p1, _CURVE_RGB[value])
    axes = (0, 0, 0)
    _draw_line(canvas, (bottom, left), (bottom, right), axes, width=1)
    _draw_line(canvas, (top, left), (bottom, left), axes, width=1)
    write_png(path, canvas)
    return {"lvef": lvef, "rvef": rvef}


def plot_mae_reconstruction(image: np.ndarray, reconstructed: np.ndarray, mask: np.ndarray, path: PathLike) -> None:
    """The MAE grid (the JAX package's ``plot_mae_reconstruction``) as a gray PNG: one row per slice, the
    columns original, masked (``(1 - mask) * image``), reconstructed and ``|reconstructed - image|``, each
    panel the ``(x, y)`` slice with x down, min-max scaled on its own.

    Args:
        image: (x, y, z) original.
        reconstructed: (x, y, z) MAE output with predicted masked patches.
        mask: (x, y, z) 1 where the patch was masked.
        path: output ``.png``.
    """
    columns = (image, (1 - mask) * image, reconstructed, np.abs(reconstructed - image))
    rows = [np.concatenate([_minmax(c[..., z]) for c in columns], axis=1) for z in range(image.shape[-1])]
    write_png(path, np.round(np.concatenate(rows, axis=0) * 255).astype(np.uint8))

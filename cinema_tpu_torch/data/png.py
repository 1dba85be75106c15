"""A PNG reader that gives what PIL gives for ``Image.open(path).convert("L")``, without PIL (the machine
with the card has none to rely on).

Every image PIL 12 opens is read: colour types 0 (gray, 1/2/4/8/16 bits), 2 (RGB, 8/16), 3 (palette,
1/2/4/8), 4 (gray + alpha, 8/16) and 6 (RGBA, 8/16), plain or Adam7-interlaced. The gray value is PIL's:

- gray below 8 bits is scaled to 0-255 (``v * 255 / (2^d - 1)``: 1 bit gives 0 and 255);
- 16-bit gray opens as ``I;16`` and ``convert("L")`` clips it at 255 (it does not scale);
- 16-bit RGB, RGBA and gray + alpha open as 8-bit ``RGB``/``RGBA`` of each sample's high byte;
- RGB, RGBA and palette entries take the luma ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``; alpha and
  ``tRNS`` are dropped; a palette index past the ``PLTE`` entries (or with no ``PLTE``) is 0.

PIL's checks are followed: the signature, the chunk names and CRCs of the chunks before the first
``IDAT``, the IHDR (13 bytes or more, a known bit depth and colour type, filter method 0, a size above 0),
the filter type of each row and the zlib stream. Image data is the run of consecutive ``IDAT`` chunks from
the first; their CRCs are not checked, and nothing after the last row is read. Each of these failures raises
``ValueError``. PIL also parses some ancillary chunks (``pHYs``, ``iCCP``, ``acTL``, ...) and refuses a file
where one is malformed; here they are skipped after their CRC check.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the bit depths each colour type allows, and its samples per pixel
BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x start, y start, x step, y step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHUNK_NAME = re.compile(rb"\w\w\w\w")
_READ_SIZE = 65536  # PIL feeds its zlib decoder at most this many bytes of a chunk at a time


def unfilter_row(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline of ``bpp`` bytes per pixel (at least 1), its PNG filter undone (None, Sub, Up, Average,
    Paeth); the left neighbour of a byte is the byte ``bpp`` before it."""
    if kind == 0:
        return line
    if kind == 1:  # Sub: a running sum of each byte lane along the row, mod 256
        pad = (-line.size) % bpp
        lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
        return np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[: line.size]
    if kind == 2:  # Up
        return line + prior
    f, b = line.tolist(), prior.tolist()
    out = [0] * len(f)
    if kind == 3:  # Average of the left and the upper neighbour
        for i, (fi, bi) in enumerate(zip(f, b)):
            out[i] = (fi + (((out[i - bpp] if i >= bpp else 0) + bi) >> 1)) & 255
    elif kind == 4:  # Paeth: of left, upper and upper-left, the one nearest to left + upper - upper-left
        for i, (fi, bi) in enumerate(zip(f, b)):
            a, c = (out[i - bpp], b[i - bpp]) if i >= bpp else (0, 0)
            pa, pb, pc = abs(bi - c), abs(a - c), abs(a + bi - 2 * c)
            out[i] = (fi + (a if pa <= pb and pa <= pc else bi if pb <= pc else c)) & 255
    else:
        raise ValueError(f"Unknown PNG filter type {kind}.")
    return np.asarray(out, np.uint8)


def _chunks(data: bytes, path) -> Tuple[bytes, Optional[bytes], List[bytes]]:
    """(IHDR body, PLTE body or None, the IDAT bodies of the first run) as PIL reads them."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file.")
    header, palette, pos = None, None, 8
    while True:  # the chunks before the first IDAT: each name and CRC checked
        kind, length = data[pos + 4 : pos + 8], int.from_bytes(data[pos : pos + 4], "big")
        if len(kind) < 4 or not _CHUNK_NAME.match(kind):
            raise ValueError(f"{path}: broken PNG file (chunk {kind!r} at byte {pos}).")
        if kind == b"IDAT":
            break
        if kind == b"IEND":
            raise ValueError(f"{path}: no IDAT chunk.")
        body, crc = data[pos + 8 : pos + 8 + length], data[pos + 8 + length : pos + 12 + length]
        if len(body) < length or len(crc) < 4 or zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            raise ValueError(f"{path}: the {kind!r} chunk is truncated or fails its CRC.")
        if kind == b"IHDR":
            header = body
        elif kind == b"PLTE":
            palette = body
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk before the image data.")
    idat = []
    while kind == b"IDAT":  # the run of IDAT chunks; their CRCs are not checked
        idat.append(data[pos + 8 : pos + 8 + length])
        pos += 12 + length
        kind, length = data[pos + 4 : pos + 8], int.from_bytes(data[pos : pos + 4], "big")
        if len(kind) == 4 and kind != b"IDAT" and not _CHUNK_NAME.match(kind):
            idat.append(None)  # PIL refuses this name if it still needs data, and stops here if not
    return header, palette, idat


def _inflate(idat: List[Optional[bytes]], size: int, path) -> bytes:
    """The first ``size`` bytes of the zlib stream, fed as PIL feeds it; nothing after them is read."""
    stream, out = zlib.decompressobj(), b""
    try:
        for body in idat:
            if body is None:
                raise ValueError(f"{path}: broken PNG file (a bad chunk name inside the image data).")
            for start in range(0, len(body), _READ_SIZE):
                out += stream.decompress(body[start : start + _READ_SIZE], size - len(out))
                if len(out) >= size:
                    return out
    except zlib.error as e:
        raise ValueError(f"{path}: broken data stream ({e}).") from None
    raise ValueError(f"{path}: the image data is truncated ({len(out)} of {size} bytes).")


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, bytes) -> samples (h, width, channels) as integers."""
    height = rows.shape[0]
    n = width * channels
    if depth == 8:
        return rows[:, :n].reshape(height, width, channels)
    if depth == 16:
        return rows[:, : 2 * n].copy().view(">u2").reshape(height, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, : n * depth].reshape(height, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(height, width, channels)


def _decode(raw: np.ndarray, width: int, height: int, channels: int, depth: int, path) -> Tuple[np.ndarray, int]:
    """Unfilter one (sub-)image of ``raw`` from its start: (samples (h, w, c), bytes used)."""
    stride = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        kind = int(rows[r, 0])
        if kind > 4:
            raise ValueError(f"{path}: unknown filter type {kind} on a row.")
        prior = out[r] = unfilter_row(kind, rows[r, 1:], prior, bpp)
    return _samples(out, width, channels, depth), height * (stride + 1)


def _luma(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_gray(data: bytes, path: Union[str, Path] = "<bytes>") -> np.ndarray:
    """The bytes of a PNG file as PIL's ``convert("L")`` gives them: uint8 (height, width)."""
    header, palette, idat = _chunks(data, path)
    if len(header) < 13:
        raise ValueError(f"{path}: truncated IHDR chunk.")
    width, height, depth, colour_type, _, filter_method, interlace = struct.unpack(">IIBBBBB", header[:13])
    if depth not in BIT_DEPTHS.get(colour_type, ()) or width == 0 or height == 0 or filter_method != 0:
        raise ValueError(f"{path}: not an image PIL opens (bit depth {depth}, colour type {colour_type}, "
                         f"size {width}x{height}, filter method {filter_method}).")
    channels = CHANNELS[colour_type]
    stride = lambda w: ((w * channels * depth + 7) // 8 + 1) if w else 0  # noqa: E731
    if interlace:  # PIL takes any non-zero interlace method as Adam7
        passes = [(x0, y0, dx, dy, -(-(width - x0) // dx) if width > x0 else 0,
                   -(-(height - y0) // dy) if height > y0 else 0) for x0, y0, dx, dy in ADAM7]
        size = sum(stride(w) * h for *_, w, h in passes if h)
        raw = np.frombuffer(_inflate(idat, size, path), np.uint8)
        samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy, w, h in passes:
            if w and h:
                part, used = _decode(raw[pos:], w, h, channels, depth, path)
                samples[y0::dy, x0::dx] = part
                pos += used
    else:
        raw = np.frombuffer(_inflate(idat, stride(width) * height, path), np.uint8)
        samples, _ = _decode(raw, width, height, channels, depth, path)
    if depth == 16:
        if colour_type == 0:  # I;16 -> L clips
            return np.minimum(samples[..., 0], 255).astype(np.uint8)
        samples = (samples >> 8).astype(np.uint8)  # RGB;16B, RGBA;16B and LA;16B keep the high byte
    if colour_type == 3:
        n = 0 if palette is None else min(len(palette) // 3, 256)
        lut = np.zeros(256, np.uint8)
        lut[:n] = _luma(np.frombuffer(palette[: 3 * n], np.uint8).reshape(n, 3)) if n else lut[:0]
        return lut[samples[..., 0]]
    if colour_type in (2, 6):
        return _luma(samples[..., :3])
    gray = samples[..., 0]
    return gray if depth >= 8 else (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)


def read_png_gray(path: Union[str, Path]) -> np.ndarray:
    """A PNG file's gray values as the JAX package reads them,
    ``np.asarray(Image.open(path).convert("L"), np.float32).T``: float32 (x, y) of 0-255."""
    return decode_gray(Path(path).read_bytes(), path).T.astype(np.float32)
